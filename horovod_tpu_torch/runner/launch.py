"""hvdrun for the port: spawn, wire, and babysit a multi-process job.

    python -m horovod_tpu_torch.runner -np 2 -- python train.py

A copy of the JAX package's ``runner/launch.py``, adapted.
† ``horovod/runner/launch.py`` (CLI), ``gloo_run.py`` (rendezvous + env +
exec + monitor), ``safe_shell_exec.py`` (process-group kill semantics).

Flow (†3.4):
1. parse hosts/flags (every config knob has a CLI flag; ``--config-file``
   YAML mirrors them — the reference's three-surface rule);
2. start the native rendezvous KV store and the coordinator service in the
   launcher process;
3. exec one worker per rank — locally via subprocess, remotely via ssh —
   with the per-rank env (rank ids + service addresses);
4. stream output; on any worker failing, terminate the rest (monitor role).

Workers bootstrap in ``horovod_tpu_torch.init()``: ``torch.distributed``
over rank 0's TCP store at ``HVDTPU_COORDINATOR_ADDR`` (NCCL on
``cuda:<HVDTPU_LOCAL_RANK>``, Gloo with ``--platform cpu``), then the
engine connects to the controller at ``HVDTPU_CONTROLLER_ADDR`` and the
metrics publisher to the KV store at ``HVDTPU_RENDEZVOUS_ADDR``; every
frame is authenticated with the job's ``HVDTPU_SECRET``.

One card a rank: the launcher leaves ``CUDA_VISIBLE_DEVICES`` as the user
set it, and each rank takes ``cuda:<local_rank>`` of that view.

Elastic mode (``--host-discovery-script`` with ``--min-np``, ``--max-np``,
``--slots``, ``--elastic-timeout``, ``--autoscale``,
``--autoscale-interval``) hands the job to
:class:`~.elastic.ElasticDriver` (:func:`run_elastic`); without a
discovery script the other elastic flags exit 2, as the reference's do.

``--slurm`` takes the hosts and their slots from the SLURM allocation
the launcher runs in (:mod:`.cloud`), where the JAX package's
``--tpu-pod`` reads a TPU-VM slice's metadata; ``--tpu-pod`` itself
exits 2, naming ``--slurm``.
"""

from __future__ import annotations

import argparse
import os
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence

from .hosts import assign_ranks, parse_hosts
from .. import chaos
from .. import config as config_mod

# What took the refused flag's place (ROADMAP.md section A, by title).
_TPU_POD_ITEM = "ROADMAP section A 'Remaining models, bindings and examples'"
_LOCAL_HOSTS = ("localhost", "127.0.0.1")


def _free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


from .cluster import local_ip as _local_ip  # noqa: E402  (shared probe)


def _install_sigterm_exit() -> None:
    """A SIGTERM to the launcher (a job timeout, a scheduler) raises
    ``SystemExit`` in the main thread, so :func:`launch_workers`'s cleanup
    terminates every worker's process group instead of orphaning them."""
    def handler(signum, frame):
        raise SystemExit(128 + signum)
    signal.signal(signal.SIGTERM, handler)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hvdrun",
        description="Launch a horovod_tpu_torch job "
                    "(reference parity: horovodrun)")
    p.add_argument("-np", "--num-proc", type=int, default=None,
                   help="total number of processes")
    p.add_argument("-cb", "--check-build", action="store_true",
                   help="print build capabilities and exit "
                        "(† horovodrun --check-build)")
    p.add_argument("-H", "--hosts", default=None,
                   help="host1:slots,host2:slots (default: localhost:np)")
    p.add_argument("--slurm", action="store_true", default=False,
                   help="take the hosts and their slots (one a card) from "
                        "the SLURM allocation (SLURM_JOB_NODELIST, "
                        "SLURM_TASKS_PER_NODE; --slots overrides the "
                        "count); -np defaults to the slots' total")
    p.add_argument("--tpu-pod", action="store_true", default=False,
                   help="TPU-VM metadata host discovery of the JAX "
                        "package; refused with exit code 2 (a GPU job "
                        "finds its hosts with --slurm)")
    p.add_argument("--ssh-port", type=int, default=22)
    # Elastic mode († horovodrun --min-np/--max-np/--host-discovery-script)
    p.add_argument("--min-np", type=int, default=None,
                   help="minimum processes an elastic job may shrink to "
                        "(default: -np)")
    p.add_argument("--max-np", type=int, default=None,
                   help="maximum processes an elastic job may grow to "
                        "(default: -np)")
    p.add_argument("--host-discovery-script", default=None,
                   help="executable printing one 'host[:slots]' line per "
                        "available host; enables elastic mode")
    p.add_argument("--slots", type=int, default=None,
                   help="default slots per discovered host (elastic "
                        "mode; lines without ':slots'), or every node's "
                        "slots under --slurm")
    p.add_argument("--autoscale", action="store_true", default=False,
                   help="close the loop between the job's /cluster "
                        "signals and the elastic rendezvous: the driver "
                        "grows the job on queue or SLO-burn pressure and "
                        "shrinks it when idle (elastic mode only; knobs "
                        "HVDTPU_AUTOSCALE_*)")
    p.add_argument("--autoscale-interval", type=float, default=None,
                   help="seconds between autoscale control ticks "
                        "(HVDTPU_AUTOSCALE_INTERVAL_SECONDS)")
    p.add_argument("--elastic-timeout", type=float, default=None,
                   help="seconds to wait for min-np slots before giving up "
                        "(elastic mode; default 600)")
    p.add_argument("--start-timeout", type=float, default=120.0,
                   help="seconds to wait for all workers to register")
    p.add_argument("--config-file", default=None,
                   help="YAML file of knobs (mirrors CLI flags)")
    # Tuning knobs († horovodrun flags mirroring HOROVOD_* envs).
    p.add_argument("--fusion-threshold-mb", type=float, default=None)
    p.add_argument("--cycle-time-ms", type=float, default=None)
    p.add_argument("--cache-capacity", type=int, default=None)
    p.add_argument("--autotune", action="store_true", default=False,
                   help="tune fusion threshold, cycle time and bucket cap "
                        "online on every rank (HVDTPU_AUTOTUNE)")
    p.add_argument("--autotune-log", default=None,
                   help="file each rank appends the tuner's decisions to "
                        "(HVDTPU_AUTOTUNE_LOG)")
    p.add_argument("--timeline-filename", default=None)
    p.add_argument("--timeline-dir", default=None,
                   help="write one Timeline v2 file per rank "
                        "(<dir>/rank<r>.json, rank<r>.r<r>.json when "
                        "np > 1) and merge the local ones "
                        "into <dir>/merged.json after the run — one "
                        "Perfetto trace, one pid lane per rank "
                        "(python -m horovod_tpu_torch.utils.timeline "
                        "merge)")
    p.add_argument("--timeline-mark-cycles", action="store_true",
                   default=False)
    p.add_argument("--log-level", default=None)
    p.add_argument("--stall-warning-time", type=float, default=None)
    p.add_argument("--platform", default=None, choices=("gpu", "cpu"),
                   help="device workers select at init(): gpu = "
                        "cuda:<local_rank> over NCCL (the default), cpu = "
                        "Gloo on the CPU (the test rig)")
    p.add_argument("--no-connectivity-check", action="store_true",
                   default=False,
                   help="skip the multi-host NIC discovery / connectivity "
                        "probe stage († driver_service probe round)")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="program to run (e.g. python train.py)")
    return p


def _knob_env(args) -> dict:
    env = {}
    if args.config_file:
        cfg = config_mod.from_yaml(args.config_file)
        defaults = config_mod.Config()
        for field, suffix, _ in config_mod._ENV_TABLE:
            val = getattr(cfg, field, None)
            if val is not None and val != getattr(defaults, field):
                if isinstance(val, bool):
                    val = "1" if val else "0"
                env["HVDTPU_" + suffix] = str(val)
    if args.fusion_threshold_mb is not None:
        env["HVDTPU_FUSION_THRESHOLD"] = str(
            int(args.fusion_threshold_mb * 1024 * 1024))
    if args.cycle_time_ms is not None:
        env["HVDTPU_CYCLE_TIME"] = str(args.cycle_time_ms)
    if args.cache_capacity is not None:
        env["HVDTPU_CACHE_CAPACITY"] = str(args.cache_capacity)
    if args.autotune:
        env["HVDTPU_AUTOTUNE"] = "1"
    if args.autotune_log:
        env["HVDTPU_AUTOTUNE_LOG"] = args.autotune_log
    if args.timeline_filename:
        env["HVDTPU_TIMELINE"] = args.timeline_filename
    if args.timeline_mark_cycles:
        env["HVDTPU_TIMELINE_MARK_CYCLES"] = "1"
    if args.log_level:
        env["HVDTPU_LOG_LEVEL"] = args.log_level
    if args.stall_warning_time is not None:
        env["HVDTPU_STALL_CHECK_TIME_SECONDS"] = str(args.stall_warning_time)
    if args.platform:
        env["HVDTPU_PLATFORM"] = args.platform
    return env


class _Worker:
    def __init__(self, rank: int, proc: subprocess.Popen) -> None:
        self.rank = rank
        self.proc = proc


# Reserved worker exit code: "membership changed — restart me on the new
# assignment".  The monitor still tears the job down, but the elastic
# driver relaunches without blacklisting anyone (a voluntary restart is
# not a fault).  EX_TEMPFAIL by analogy.
RESTART_EXIT_CODE = 75
# Reserved worker exit code: "a collective failed UNDER me — I am a
# victim of some other rank's fault, not the fault itself".  The driver
# relaunches but does not blacklist this worker's host.
VICTIM_EXIT_CODE = 76


def launch_workers(command: Sequence[str], *, np_total: int,
                   hosts_spec: Optional[str] = None,
                   extra_env: Optional[dict] = None,
                   ssh_port: int = 22,
                   verbose: bool = False,
                   connectivity_check: bool = True,
                   failure_info: Optional[dict] = None,
                   services_hook=None,
                   timeline_dir: Optional[str] = None) -> int:
    """Start services + workers; wait; return the first failing rank's
    exit code (0 when every rank exits 0).  Local ranks run as child
    processes, remote ranks through ``ssh`` († gloo_run exec path).

    ``services_hook(services)`` runs once the control-plane services are
    up — :func:`..api.run_func` and the elastic driver use it to reach the
    job's KV store.  ``failure_info``, when given, receives the first
    failing rank's ``rank``, ``host`` and ``code`` (the elastic driver
    blacklists that host).
    With ``verbose``, every rank's exit code is reported on stderr as
    ``[launcher] rank <r> exited <code>``."""
    from .cluster import DriverServices, pick_coordinator_port

    hosts = parse_hosts(hosts_spec) if hosts_spec else \
        parse_hosts(f"localhost:{np_total}")
    assignment = assign_ranks(hosts, np_total)

    # A job on this host alone needs no routable address (and never asks
    # the NIC inventory for one).
    is_local_job = all(h in _LOCAL_HOSTS for _, h, _ in assignment)
    my_ip = "127.0.0.1" if is_local_job else _local_ip()
    is_local_job = is_local_job or all(h in (*_LOCAL_HOSTS, my_ip)
                                       for _, h, _ in assignment)
    service_ip = "127.0.0.1" if is_local_job else my_ip

    # Per-job shared secret authenticating every control-plane frame
    # († secret.py: random HMAC secret per horovodrun invocation).  An
    # inherited or explicitly passed one is reused.
    import secrets as _secrets
    job_secret = ((extra_env or {}).get("HVDTPU_SECRET")
                  or os.environ.get("HVDTPU_SECRET")
                  or _secrets.token_hex(16))
    # Publish to this process so driver-side clients (run_func's
    # collector, the probe stage) authenticate with the same credential;
    # assignment (not setdefault) so an explicitly passed secret wins over
    # a stale one.
    os.environ["HVDTPU_SECRET"] = job_secret

    # The stall knobs decide controller behavior (round-abort timeout;
    # the stall inspector's straggler-attribution horizon); they may
    # arrive via --config-file (worker-env only), so consult the worker
    # env block before the launcher's own env, under every prefix the
    # worker-side config parser accepts (config._PREFIXES).
    def _stall_knob(suffix: str) -> Optional[float]:
        for src in (extra_env or {}, os.environ):
            for prefix in ("HVDTPU_", "HOROVOD_TPU_", "HOROVOD_"):
                raw = src.get(prefix + suffix)
                if raw:
                    try:
                        return float(raw)
                    except ValueError:
                        return None  # config rejects it worker-side
        return None

    stall_shutdown_s = _stall_knob("STALL_SHUTDOWN_TIME_SECONDS")
    stall_warn_s = _stall_knob("STALL_CHECK_TIME_SECONDS")
    services = DriverServices(np_total, service_ip=service_ip,
                              secret=job_secret,
                              stall_shutdown_s=stall_shutdown_s,
                              stall_warn_s=stall_warn_s)
    if services_hook is not None:
        try:
            services_hook(services)
        except Exception as e:  # the hook must never kill the launch
            print(f"[launcher] services_hook failed: {e}", file=sys.stderr)
    if is_local_job:
        coord_port = _free_port()
        coord_host = "127.0.0.1"
    else:
        coord_port = pick_coordinator_port()
        coord_host = assignment[0][1]
        if connectivity_check:
            # NIC discovery + connectivity probe round († driver_service
            # probe tasks): pick a driver address every host can actually
            # reach and the coordinator host's peer-visible address,
            # instead of trusting the default-route IP and DNS names.
            try:
                routing = _run_probe_stage(
                    hosts, services, my_ip=my_ip, ssh_port=ssh_port,
                    verbose=verbose)
            except Exception as e:
                # Any probe-stage failure must release the KV/controller
                # servers and surface a named diagnosis, whatever the
                # exception type (KV waits raise TimeoutError etc.).
                services.close()
                print(f"[launcher] connectivity check failed: {e}",
                      file=sys.stderr)
                raise
            if routing["driver_addr"]:
                services.service_ip = routing["driver_addr"]
            coord_host = routing["host_addrs"].get(
                assignment[0][1], coord_host)
            if verbose:
                print(f"[launcher] probe: driver={services.service_ip} "
                      f"coordinator={coord_host} nics={routing['nics']}",
                      file=sys.stderr)

    workers: List[_Worker] = []
    failed = threading.Event()
    exit_codes: dict[int, int] = {}

    if timeline_dir:
        os.makedirs(timeline_dir, exist_ok=True)

    def base_env(rank: int, local_rank: int) -> dict:
        # Full process env (ssh-launched workers inherit the launcher's
        # environment) + the shared control-plane block.
        env = dict(os.environ)
        env.update(services.worker_env(
            rank, local_rank,
            coordinator_addr=f"{coord_host}:{coord_port}",
            extra_env=extra_env))
        if timeline_dir:
            # One Timeline v2 file per rank; merged after the run into
            # a single multi-lane Perfetto trace.
            env["HVDTPU_TIMELINE"] = os.path.join(
                timeline_dir, f"rank{rank}.json")
        return env

    def stream(worker: _Worker) -> None:
        assert worker.proc.stdout is not None
        for line in worker.proc.stdout:
            sys.stdout.write(f"[{worker.rank}]<stdout>: {line}")
            sys.stdout.flush()

    try:
        for rank, host, local_rank in assignment:
            # Chaos site: one traversal per worker spawned.  err aborts
            # the launch; delay staggers worker starts.
            chaos.fire("spawn")
            env = base_env(rank, local_rank)
            if host in (*_LOCAL_HOSTS, my_ip):
                proc = subprocess.Popen(
                    list(command), env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, start_new_session=True)
            else:
                # ssh fan-out: env goes on the remote command line since ssh
                # doesn't forward arbitrary vars († gloo_run builds the same
                # `ssh host env K=V ... cmd` line) — EXCEPT the job secret,
                # which would be world-readable in /proc/<pid>/cmdline on
                # the remote host; it travels over ssh stdin instead.
                # Forward the control-plane block, interpreter paths, AND
                # every caller-supplied extra_env key — the remote shell
                # starts from a fresh ssh environment, so anything not on
                # this line is silently dropped for remote ranks.
                forwarded = set(extra_env or ())
                env_kv = " ".join(
                    f"{k}={shlex.quote(v)}" for k, v in env.items()
                    if k != "HVDTPU_SECRET"
                    and (k in forwarded
                         or k.startswith(("HVDTPU_", "HOROVOD_", "PATH",
                                          "PYTHONPATH"))))
                remote = ("IFS= read -r HVDTPU_SECRET && "
                          "export HVDTPU_SECRET && "
                          f"cd {shlex.quote(os.getcwd())} && env {env_kv} "
                          + " ".join(shlex.quote(c) for c in command))
                proc = subprocess.Popen(
                    ["ssh", "-p", str(ssh_port),
                     "-o", "StrictHostKeyChecking=no", host, remote],
                    stdin=subprocess.PIPE,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, start_new_session=True)
                try:
                    assert proc.stdin is not None
                    proc.stdin.write(job_secret + "\n")
                    proc.stdin.close()
                except (BrokenPipeError, OSError):
                    pass  # ssh died instantly; the monitor reports it

            worker = _Worker(rank, proc)
            workers.append(worker)
            threading.Thread(target=stream, args=(worker,),
                             daemon=True).start()

        # Monitor († launcher kills everyone when any worker dies nonzero).
        pending = {w.rank: w for w in workers}
        code = 0
        while pending:
            # Chaos site: one traversal per monitor liveness pass (the
            # launcher's heartbeat over its workers) — a driver-side
            # fault here tears the job down like a dying launcher would.
            chaos.fire("heartbeat")
            exited = [(rank_id, rc) for rank_id, w in list(pending.items())
                      if (rc := w.proc.poll()) is not None]
            # A culprit's exit outranks a victim's or a restart's seen in
            # the same pass: survivors of a dying rank exit with the
            # victim code within milliseconds of it, and rank order alone
            # would blame (and spare) the wrong host.
            exited.sort(key=lambda e: e[1] in (RESTART_EXIT_CODE,
                                               VICTIM_EXIT_CODE))
            for rank_id, rc in exited:
                exit_codes[rank_id] = rc
                del pending[rank_id]
                if verbose:
                    print(f"[launcher] rank {rank_id} exited {rc}",
                          file=sys.stderr, flush=True)
                if rc != 0 and not failed.is_set():
                    # First failure only: later nonzero exits are the
                    # launcher's own SIGTERMs, not independent faults
                    # († blacklist the host that actually crashed).
                    failed.set()
                    code = rc
                    if failure_info is not None:
                        host = next(h for r, h, _ in assignment
                                    if r == rank_id)
                        failure_info.update(
                            {"rank": rank_id, "host": host, "code": rc})
                    if verbose:
                        print(f"[launcher] rank {rank_id} exited {rc}; "
                              "terminating remaining workers",
                              file=sys.stderr)
                    for other in pending.values():
                        _terminate(other.proc)
            time.sleep(0.1)
        if timeline_dir:
            _merge_timeline_dir(timeline_dir, np_total, verbose=verbose)
        return code
    finally:
        for w in workers:
            if w.proc.poll() is None:
                _terminate(w.proc)
        services.close()


def _merge_timeline_dir(timeline_dir: str, np_total: int, *,
                        verbose: bool = False) -> None:
    """Best-effort post-run merge of the per-rank timelines written on
    THIS host (ssh-launched ranks write on their own hosts) into
    ``<dir>/merged.json`` — one trace, one pid lane per rank.  Only THIS
    launch's ranks are merged: a reused dir (a smaller -np)
    may hold rank files from a previous larger run, and rebasing those
    dead-epoch traces onto this run's clock would fabricate lanes."""
    from ..utils.timeline import merge_timelines, rank_suffixed

    # A rank of a job of more than one opens its HVDTPU_TIMELINE path with
    # the rank infix (``rank1.r1.json``); the reference looked only for
    # the bare name and so merged nothing at np > 1.
    rank_files = [
        path for r in range(np_total)
        if os.path.exists(path := rank_suffixed(
            os.path.join(timeline_dir, f"rank{r}.json"), r, np_total))]
    if not rank_files:
        return
    out = os.path.join(timeline_dir, "merged.json")
    try:
        summary = merge_timelines(out, rank_files)
    except (OSError, ValueError) as e:
        print(f"[launcher] timeline merge failed: {e}", file=sys.stderr)
        return
    print(f"[launcher] merged {len(summary['ranks'])} rank timeline(s) "
          f"-> {out}", file=sys.stderr)


def _run_probe_stage(hosts, services, *, my_ip: str, ssh_port: int,
                     verbose: bool = False) -> dict:
    """Spawn one probe task per job host (ssh for remote, subprocess for
    the driver's own host) and aggregate via :mod:`.probe`."""
    from .probe import local_addresses, run_probe_stage
    from .._native import KvClient

    host_keys = []
    for h in hosts:
        if h.hostname not in host_keys:
            host_keys.append(h.hostname)
    candidates = ",".join(local_addresses())
    kv_port = services.kv.port
    secret = services.secret

    def launch_fn(host: str) -> subprocess.Popen:
        argv = [sys.executable, "-m", "horovod_tpu_torch.runner.probe",
                host, candidates, str(kv_port)]
        if host in (*_LOCAL_HOSTS, my_ip):
            env = dict(os.environ)
            env["HVDTPU_SECRET"] = secret
            return subprocess.Popen(argv, env=env,
                                    stdout=subprocess.DEVNULL
                                    if not verbose else None)
        env_kv = " ".join(
            f"{k}={shlex.quote(v)}" for k, v in os.environ.items()
            if k != "HVDTPU_SECRET"
            and k.startswith(("HVDTPU_", "PATH", "PYTHONPATH")))
        remote = ("IFS= read -r HVDTPU_SECRET && export HVDTPU_SECRET && "
                  f"cd {shlex.quote(os.getcwd())} && env {env_kv} "
                  + " ".join(shlex.quote(c) for c in argv))
        proc = subprocess.Popen(
            ["ssh", "-p", str(ssh_port),
             "-o", "StrictHostKeyChecking=no", host, remote],
            stdin=subprocess.PIPE, text=True,
            stdout=subprocess.DEVNULL if not verbose else None)
        try:
            assert proc.stdin is not None
            proc.stdin.write(secret + "\n")
            proc.stdin.close()
        except (BrokenPipeError, OSError):
            pass
        return proc

    kv = KvClient("127.0.0.1", kv_port, secret=secret)
    try:
        return run_probe_stage(host_keys, kv=kv, launch_fn=launch_fn)
    finally:
        kv.close()


def _terminate(proc: subprocess.Popen) -> None:
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
    except (ProcessLookupError, PermissionError):
        pass
    try:
        proc.wait(timeout=5)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


def run(command: Sequence[str], np: int, *, hosts: Optional[str] = None,
        env: Optional[dict] = None, verbose: bool = False) -> int:
    """Python API († ``horovod.run``)."""
    return launch_workers(command, np_total=np, hosts_spec=hosts,
                          extra_env=env, verbose=verbose)


def _check_build() -> int:
    """† ``horovodrun --check-build``: print what this build supports."""
    import torch.distributed

    import horovod_tpu_torch as hvd

    def mark(flag: bool) -> str:
        return "[X]" if flag else "[ ]"

    print("horovod_tpu_torch:\n")
    print("Available Frameworks:")
    print(f"    {mark(True)} PyTorch")
    print("\nAvailable Controllers:")
    print(f"    {mark(hvd.native_built())} native (C++ KV + coordinator)")
    print(f"    {mark(torch.distributed.is_available())} "
          "torch.distributed rendezvous (TCP store)")
    print("\nAvailable Tensor Operations:")
    print(f"    {mark(hvd.nccl_built() > 0)} NCCL")
    print(f"    {mark(hvd.cuda_built())} CUDA")
    print(f"    {mark(hvd.gloo_built())} Gloo (CPU)")
    print(f"    {mark(hvd.mpi_built())} MPI")
    return 0


def run_elastic(command: Sequence[str], args, extra_env: dict) -> int:
    """Elastic CLI path († ``horovodrun -np 2 --min-np 1
    --host-discovery-script ./d.sh python train.py``): hand supervision to
    the ElasticDriver, which polls discovery, blacklists crashed hosts,
    and relaunches on the surviving assignment; workers resume from their
    last ``state.commit()``."""
    from .elastic import ElasticDriver, ScriptDiscovery

    if args.hosts:
        print("hvdrun: -H/--hosts conflicts with --host-discovery-script "
              "(elastic hosts come from the discovery script)",
              file=sys.stderr)
        return 2
    min_np = args.min_np if args.min_np is not None else args.num_proc
    max_np = args.max_np if args.max_np is not None else args.num_proc
    if not (1 <= min_np <= args.num_proc <= max_np):
        print(f"hvdrun: need 1 <= min-np ({min_np}) <= np "
              f"({args.num_proc}) <= max-np ({max_np})", file=sys.stderr)
        return 2
    discovery = ScriptDiscovery(args.host_discovery_script,
                                default_slots=args.slots or 1)
    driver = ElasticDriver(discovery, min_np=min_np, max_np=max_np)
    cfg = config_mod.from_env()
    autoscale = None
    if args.autoscale or cfg.autoscale:
        from ..autoscale import PolicyConfig
        autoscale = PolicyConfig(
            min_np=min_np, max_np=max_np,
            queue_high=cfg.autoscale_queue_high,
            queue_low=cfg.autoscale_queue_low,
            burn_threshold=cfg.autoscale_burn_threshold,
            scale_up_cooldown_s=cfg.autoscale_up_cooldown_s,
            scale_down_cooldown_s=cfg.autoscale_down_cooldown_s,
            stale_after_s=cfg.autoscale_stale_s,
            forecast_horizon_s=cfg.autoscale_forecast_horizon_s)
    return driver.run_job(
        command, extra_env=extra_env,
        autoscale=autoscale,
        autoscale_interval_s=(args.autoscale_interval
                              if args.autoscale_interval is not None
                              else cfg.autoscale_interval_s),
        slot_timeout_s=(args.elastic_timeout
                        if args.elastic_timeout is not None else 600.0),
        launch_kwargs={
            "ssh_port": args.ssh_port,
            "verbose": args.verbose,
            "connectivity_check": not args.no_connectivity_check,
            # Per-epoch rank timelines share the dir; each relaunch
            # overwrites rank files and refreshes merged.json.
            "timeline_dir": args.timeline_dir,
        })


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.check_build:
        try:
            return _check_build()
        except BrokenPipeError:  # e.g. piped into `head`
            return 0
    command = list(args.command)
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        print("hvdrun: no command given", file=sys.stderr)
        return 2
    if args.tpu_pod:
        print(f"hvdrun: --tpu-pod is not ported to horovod_tpu_torch: it "
              f"reads TPU-VM metadata; a GPU job finds its hosts with "
              f"--slurm ({_TPU_POD_ITEM})", file=sys.stderr)
        return 2
    if args.slurm:
        if args.hosts:
            print("hvdrun: --slurm conflicts with -H/--hosts",
                  file=sys.stderr)
            return 2
        from .cloud import SlurmUnavailable, slurm_hosts
        try:
            found = slurm_hosts(default_slots=args.slots)
        except SlurmUnavailable as e:
            print(f"hvdrun: {e}", file=sys.stderr)
            return 2
        args.hosts = ",".join(f"{h.hostname}:{h.slots}" for h in found)
        args.slots = None   # consumed; keep the elastic-only guard honest
        if args.num_proc is None:
            args.num_proc = sum(h.slots for h in found)
        if args.verbose:
            print(f"[launcher] slurm discovery: {args.hosts}",
                  file=sys.stderr)
    if args.num_proc is None or args.num_proc < 1:
        print("hvdrun: -np/--num-proc (>= 1) is required", file=sys.stderr)
        return 2
    extra_env = _knob_env(args)
    if not args.host_discovery_script and (
            args.min_np is not None or args.max_np is not None
            or args.slots is not None or args.elastic_timeout is not None
            or args.autoscale or args.autoscale_interval is not None):
        print("hvdrun: --min-np/--max-np/--slots/--elastic-timeout/"
              "--autoscale require --host-discovery-script (elastic "
              "mode)", file=sys.stderr)
        return 2
    _install_sigterm_exit()
    if args.host_discovery_script:
        return run_elastic(command, args, extra_env)
    return launch_workers(command, np_total=args.num_proc,
                          hosts_spec=args.hosts, extra_env=extra_env,
                          ssh_port=args.ssh_port, verbose=args.verbose,
                          connectivity_check=not args.no_connectivity_check,
                          timeline_dir=args.timeline_dir)


if __name__ == "__main__":
    sys.exit(main())
