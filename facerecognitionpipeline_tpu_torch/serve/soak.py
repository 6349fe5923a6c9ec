"""The recycle soak: the server as it is deployed, across worker recycles.

Counterpart of `examples/recycle_soak.py`. `run_recycle_soak` launches the
server CLI (`cli/face_recognition_server.py`) under its `--max_requests`
supervisor (`serve/server.py::_supervise`) as a process of its own, drives
it from client processes (`Clients`: started with `spawn`, they import
neither torch nor CUDA; serve/bench.py's clients are the same), samples the serving worker (the pid `/health` names) every few
answered requests, finalizes the session and stops the supervisor with
SIGTERM. It records:

* per sample, each on a connection of its own (as the JAX example's
  `requests.get` does, so that no idle client holds a drain): the worker's
  RSS from `/proc/<pid>/status` and `/stats`'s `current_gpu_vram_mb`;
* per generation (one worker process): the example's block (`summarize`),
  its start seconds (first seen as the supervisor's child -> its first
  answer), the requests it answered and their p50 as the clients saw them,
  the downtime of the recycle that started it as the clients saw it (last
  answer of the generation before -> first answer of this one), and the
  drain that ended it (its last answer -> its exit), and the kernels it
  launched beside the steps it dispatched (the line each worker prints on
  its way out, `server.LAUNCH_LINE`). Worker processes are seen by polling
  the supervisor's children every `POLL_S`;
* on a card: nvidia-smi's memory.used before the supervisor starts and
  after it exits, and at each generation's first sample memory.used, the
  compute processes nvidia-smi lists and the device files the supervisor
  holds open.

A worker or client that fails, an answer other than 200, a request not
answered within `ANSWER_TIMEOUT_S`, no answer at all for `STALL_S`, or a
supervisor that does not return after SIGTERM raises `SoakError` with the
tail of the supervisor's log. `check_soak` holds a finished run to its
bounds.

This module imports neither torch nor cv2 at import time: the clients
import it.
"""

from __future__ import annotations

import http.client
import json
import multiprocessing
import os
import pickle
import queue
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from facerecognitionpipeline_tpu_torch.serve import rawproto
from facerecognitionpipeline_tpu_torch.serve.client import HTTPSession

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SERVER_MODULE = "facerecognitionpipeline_tpu_torch.cli.face_recognition_server"
SESSION = "soak"
POLL_S = 0.05  # how often the supervisor's children are listed
RETRY_S = 0.2  # a client's wait before it sends a refused request again
ANSWER_TIMEOUT_S = 120.0  # one accepted request must be answered within this
STOP_TIMEOUT_S = 60.0  # SIGTERM -> the supervisor returns
STALL_S = 600.0  # no answer at all for this long fails the soak or a bench
START_TIMEOUT_S = 120.0  # spawned clients are ready to send within this
MIN_GENERATIONS = 3  # worker processes a soak must show
# the line a worker prints on its way out (serve/server.py's LAUNCH_LINE;
# not imported from there: the clients import this module, not torch)
LAUNCH_LINE = "[kernels] "
# the example's server build (examples/recycle_soak.py:71-76)
EXAMPLE_SERVER = ("--architecture", "ir_18", "--max_faces", "8", "--batch_max", "2")


class SoakError(RuntimeError):
    """A soak that could not run to its end."""


def rss_mb(pid: int) -> Optional[float]:
    """VmRSS of a process in MiB, None when it is gone."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        return None
    return None


def summarize(samples: Sequence[Dict], frames_sent: int, max_requests: int) -> Dict:
    """The example's report (`examples/recycle_soak.py:133-151`): one
    generation per worker pid, in the order the samples first name it."""
    gens: Dict[int, List[Dict]] = {}
    for s in samples:
        gens.setdefault(s["pid"], []).append(s)
    return {
        "frames_sent": frames_sent,
        "max_requests": max_requests,
        "generations": [
            {
                "pid": pid,
                "n_samples": len(rows),
                "rss_first_mb": rows[0]["rss_mb"],
                "rss_last_mb": rows[-1]["rss_mb"],
                "growth_mb": round(rows[-1]["rss_mb"] - rows[0]["rss_mb"], 1),
            }
            for pid, rows in gens.items()
        ],
        "samples": list(samples),
    }


# ------------------------------------------------------------ processes


def _stat_state(pid: int) -> Optional[str]:
    """The state letter of /proc/<pid>/stat, None when the pid is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            stat = f.read()
    except OSError:
        return None
    return stat[stat.rindex(")") + 2]


def _started(pid: int) -> Optional[float]:
    """When a process started, on this process's time.monotonic() clock:
    its start time since boot (/proc/<pid>/stat, clock ticks) moved by the
    offset between the boot clock (/proc/uptime) and the monotonic one."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            stat = f.read()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except OSError:
        return None
    now = time.monotonic()
    ticks = int(stat[stat.rindex(")") + 2:].split()[19])
    return now - uptime + ticks / os.sysconf("SC_CLK_TCK")


def _alive(pid: int) -> bool:
    state = _stat_state(pid)
    return state is not None and state != "Z"


def _tgid(pid: int) -> Optional[int]:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("Tgid:"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


def _is_process(pid: int) -> bool:
    """Whether a task is a thread-group leader: its Tgid is its own id and
    the lowest of its group's tasks."""
    try:
        tasks = [int(t) for t in os.listdir(f"/proc/{pid}/task")]
    except OSError:
        return False
    return _tgid(pid) == pid and min(tasks) == pid


def _children(pid: int) -> List[int]:
    """The child processes of `pid`, from its /proc children file. Some
    kernels list a child's threads there too (the H100 host the soak was
    first run on did), so only thread-group leaders count."""
    try:
        with open(f"/proc/{pid}/task/{pid}/children") as f:
            kids = [int(c) for c in f.read().split()]
    except OSError:
        return []
    return [k for k in kids if _is_process(k)]


class _Workers:
    """Polls the supervisor's children: every worker pid with the monotonic
    time it started (read from /proc, so a late poll does not move it) and
    the time it was first seen gone (an exited child not yet reaped counts
    as gone)."""

    def __init__(self, supervisor_pid: int):
        self.supervisor_pid = supervisor_pid
        self.t0 = time.monotonic()
        self.first_seen: Dict[int, float] = {}
        self.gone: Dict[int, float] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="soak-workers", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.poll()
            self._stop.wait(POLL_S)

    def poll(self) -> None:
        now = time.monotonic()
        alive = {c for c in _children(self.supervisor_pid) if _alive(c)}
        for pid in alive:
            if pid not in self.first_seen:
                self.first_seen[pid] = _started(pid) or now
        for pid in self.first_seen:
            if pid not in alive and pid not in self.gone and not _alive(pid):
                self.gone[pid] = now

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self.poll()

    def order(self) -> List[int]:
        return sorted(self.first_seen, key=self.first_seen.get)


def launch_reports(log_path: str) -> Dict[int, Dict]:
    """The launch line each worker printed into the supervisor's log, by
    pid (a worker stopped by SIGTERM while it shut down prints twice: the
    last line counts)."""
    out: Dict[int, Dict] = {}
    with open(log_path, errors="replace") as f:
        for line in f:
            if line.startswith(LAUNCH_LINE):
                rep = json.loads(line[len(LAUNCH_LINE):])
                out[rep["pid"]] = rep
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: str, n: int = 6000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n))
            return f.read().decode("utf-8", errors="replace")
    except OSError as e:
        return f"(no log: {e})"


def _smi(*query: str) -> List[List[str]]:
    r = subprocess.run(
        ["nvidia-smi", *query, "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise SoakError(f"nvidia-smi {' '.join(query)} failed: {r.stderr.strip()}")
    return [[x.strip() for x in line.split(",")] for line in r.stdout.strip().splitlines()
            if line.strip()]


def card_used_mb() -> float:
    """memory.used of the first card, MiB, as nvidia-smi reads it."""
    return float(_smi("--query-gpu=memory.used")[0][0])


def _device_files(pid: int) -> List[str]:
    """The /dev/nvidia* files a process holds open (a CUDA context holds
    several)."""
    out = []
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return out
    for fd in fds:
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.append(target)
    return sorted(set(out))


def _card_probe(supervisor_pid: int, cuda: bool) -> Dict:
    probe = {"supervisor_device_files": _device_files(supervisor_pid)}
    if cuda:
        probe["card_used_mb"] = card_used_mb()
        probe["compute_apps"] = [
            {"pid": int(row[0]), "used_mb": float(row[1])}
            for row in _smi("--query-compute-apps=pid,used_memory") if row[0].isdigit()
        ]
    return probe


# --------------------------------------------------------------- clients


def _post(session: HTTPSession, url: str, request: Dict, k: int):
    """POST `request` as frame number k (its frame_count / X-Frame-Count)."""
    if "json" in request:
        return session.post(url + request["path"], json={**request["json"], "frame_count": k},
                            timeout=ANSWER_TIMEOUT_S)
    return session.post(url + request["path"], data=request["data"],
                        headers={**request["headers"], rawproto.HEADER_COUNT: str(k)},
                        timeout=ANSWER_TIMEOUT_S)


def _payload_bytes(request: Dict) -> int:
    if "json" in request:
        return len(json.dumps({**request["json"], "frame_count": 0}).encode())
    return len(request["data"])


def _connect(session: HTTPSession, url: str) -> None:
    """Open the session's kept-alive connection with GET /health, again
    while the server's listen queue refuses or resets it (clients that
    start together connect at once), for at most START_TIMEOUT_S."""
    deadline = time.monotonic() + START_TIMEOUT_S
    while True:
        try:
            r = session.get(url + "/health", timeout=ANSWER_TIMEOUT_S)
            break
        except (ConnectionError, http.client.HTTPException):
            if time.monotonic() > deadline:
                raise
            time.sleep(RETRY_S)
    if r.status_code != 200:
        raise SoakError(f"GET /health answered HTTP {r.status_code}: {r.text[:2000]}")


def _client(cid: int, url: str, requests_path: str, out_path: str, answers,
            count: int, seconds: float, barrier, retry: bool) -> None:
    """One client process. Posts requests[(cid + i) % len(requests)] (the
    list pickled at `requests_path`) as
    frame i + 1, each after the answer to the last: `count` answers or, with
    count 0, until `seconds` after it passes `barrier` (the parent and every
    client meet there, each with its connection open, so that all start
    together). With `retry` a request
    the server refuses or drops (no worker listening: a recycle) is sent
    again after RETRY_S; without, that fails the client, as an answer other
    than 200 or none within ANSWER_TIMEOUT_S always does. Puts `cid` on
    `answers` per answer and writes {"rows": [[t_answer (monotonic), ms,
    body text], ...], "cpu_s", "error", "torch_imported"} to out_path."""
    session = HTTPSession()
    rows: list = []
    error, cpu_s = None, 0.0
    try:
        with open(requests_path, "rb") as f:
            requests = pickle.load(f)
        if barrier is not None:
            _connect(session, url)
            barrier.wait(START_TIMEOUT_S)
        stop = time.monotonic() + seconds
        cpu0 = time.process_time()
        while (len(rows) < count) if count else (time.monotonic() < stop):
            k = len(rows) + 1
            t0 = time.monotonic()
            try:
                r = _post(session, url, requests[(cid + k - 1) % len(requests)], k)
            except TimeoutError as e:
                raise SoakError(f"request {k} not answered in {ANSWER_TIMEOUT_S:.0f} s") from e
            except (ConnectionError, http.client.HTTPException):
                if not retry:
                    raise
                time.sleep(RETRY_S)  # refused or reset: no worker is listening yet
                continue
            t1 = time.monotonic()
            if r.status_code != 200:
                raise SoakError(f"request {k} answered HTTP {r.status_code}: {r.text[:2000]}")
            rows.append([t1, 1e3 * (t1 - t0), r.text])
            answers.put(cid)
        cpu_s = time.process_time() - cpu0
    except Exception as e:  # noqa: BLE001 - written for the parent, then re-raised
        error = f"{type(e).__name__}: {e}"
        raise
    finally:
        session.close()
        with open(out_path, "w") as f:
            json.dump({"rows": rows, "cpu_s": cpu_s, "error": error,
                       "torch_imported": "torch" in sys.modules}, f)


class Clients:
    """`n` client processes (`_client`), started with `spawn` so that they
    import numpy and this module but not torch: the recycle soak's and
    serve/bench.py's. Each posts `requests` to `url` in turn, `count`
    answers each or, with count 0, for `seconds` from one start that
    `start()` gives them all; `retry` as `_client` says. The requests and
    their records are written under `workdir`: a request passed as a
    process argument goes down a pipe that the parent fills only as fast as
    each child starts, so that megabytes of frames would start the clients
    one after another."""

    def __init__(self, n: int, url: str, requests: Sequence[Dict], workdir: str, name: str,
                 count: int = 0, seconds: float = 0.0, retry: bool = False):
        ctx = multiprocessing.get_context("spawn")
        self.answers = ctx.Queue()
        self.barrier = None if count else ctx.Barrier(n + 1)
        self.out_paths = [os.path.join(workdir, f"{name}-{i}.json") for i in range(n)]
        requests_path = os.path.join(workdir, f"{name}-requests.pkl")
        with open(requests_path, "wb") as f:
            pickle.dump(list(requests), f)
        self.procs = [
            ctx.Process(target=_client, name=f"{name}-{i}", daemon=True,
                        args=(i, url, requests_path, self.out_paths[i], self.answers, count,
                              seconds, self.barrier, retry))
            for i in range(n)
        ]

    def _raise_on_failed(self, what: str) -> None:
        errors = []
        for p, out in zip(self.procs, self.out_paths):
            if p.exitcode not in (None, 0):
                try:
                    with open(out) as f:
                        errors.append(f"{p.name}: {json.load(f)['error']}")
                except (OSError, ValueError, KeyError):
                    errors.append(f"{p.name}: exit code {p.exitcode}")
        if errors:
            raise SoakError(f"{what}: " + "; ".join(errors))

    def start(self) -> float:
        """Start the processes; with a time limit, wait until every one is
        ready and let them all go. Returns the monotonic start."""
        for p in self.procs:
            p.start()
        if self.barrier is not None:
            deadline = time.monotonic() + START_TIMEOUT_S
            while self.barrier.n_waiting < len(self.procs):
                self._raise_on_failed("a client failed before it was ready")
                if time.monotonic() > deadline:
                    raise SoakError(f"{len(self.procs) - self.barrier.n_waiting} of "
                                    f"{len(self.procs)} clients not ready in "
                                    f"{START_TIMEOUT_S:.0f} s")
                time.sleep(0.05)
            self.barrier.wait(START_TIMEOUT_S)
        return time.monotonic()

    def wait(self, on_answer=None, check=None) -> List[Dict]:
        """Drain the answers (calling on_answer(answers so far) on each)
        until every client has exited 0; return their records in client
        order. Raises SoakError naming the errors of the clients that
        failed, with check()'s message when it returns one (checked while no
        answer comes), or after no answer for STALL_S."""
        answered = 0
        last = time.monotonic()
        while True:
            try:
                self.answers.get(timeout=0.25)
            except queue.Empty:
                msg = check() if check is not None else None
                if msg:
                    raise SoakError(f"{msg} after {answered} answers")
                self._raise_on_failed("a client failed")
                if all(p.exitcode == 0 for p in self.procs):
                    break
                if time.monotonic() - last > STALL_S:
                    raise SoakError(f"no answer for {STALL_S:.0f} s after {answered} answers")
                continue
            answered += 1
            last = time.monotonic()
            if on_answer is not None:
                on_answer(answered)
        records = []
        for p, out in zip(self.procs, self.out_paths):
            p.join(timeout=30)
            with open(out) as f:
                records.append(json.load(f))
        return records

    def close(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
        self.answers.close()
        self.answers.join_thread()


# ------------------------------------------------------------------ soak


def run_recycle_soak(
    server_argv: Sequence[str],
    request: Dict,
    frames: int,
    max_requests: int,
    clients: int = 1,
    sample_every: int = 10,
    device="cuda",
    workdir: Optional[str] = None,
    port: Optional[int] = None,
) -> Dict:
    """Serve `frames` frame requests, split evenly over `clients`
    processes, through the supervised CLI started with `server_argv` plus
    --max_requests, --session_name, --output_dir, --host, --port and the
    device. `request` is {"path": "/process_frame", "json": {"frame": b64}}
    or {"path": "/process_frame_raw", "data": bytes, "headers": {...}};
    each client sends it as frames 1..n. Returns the example's report
    (`summarize`) with each generation's timings, plus "answered",
    "faces_answered" (faces_detected summed over the answers),
    "payload_bytes", the finalized session's "statistics" and
    "attendance", "supervisor_rc", "workers" (per worker process: pid,
    timings, card probe, "steps" and "launches" from its launch line, None
    without one), the card figures, "log" (the supervisor's log) and
    "answers" (per client, [t, ms, body text] rows).

    device: 'cuda' (the default) raises without a card; 'cpu' runs the
    workers with --use_cpu."""
    from facerecognitionpipeline_tpu_torch.utils.device import resolve_device

    cuda = resolve_device(device).type == "cuda"
    if frames % clients:
        raise ValueError(f"frames={frames} must split evenly over clients={clients}")
    workdir = workdir or tempfile.mkdtemp(prefix="recycle_soak_")
    os.makedirs(workdir, exist_ok=True)
    output_dir = os.path.join(workdir, "sessions")
    log_path = os.path.join(workdir, "supervisor.log")
    port = port or _free_port()
    url = f"http://127.0.0.1:{port}"
    cmd = [
        sys.executable, "-m", SERVER_MODULE, *server_argv,
        "--max_requests", str(max_requests), "--session_name", SESSION,
        "--output_dir", output_dir, "--host", "127.0.0.1", "--port", str(port),
        *(["--device", "cuda"] if cuda else ["--use_cpu"]),
    ]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["PYTHONUNBUFFERED"] = "1"
    result: Dict = {"clients": clients, "log": log_path}
    if cuda:
        result["card"] = ", ".join(_smi("--query-gpu=name,power.limit")[0])
        result["card_used_mb_before"] = card_used_mb()
    log = open(log_path, "w")
    sup = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=workdir)
    workers = _Workers(sup.pid)
    result["supervisor_pid"] = sup.pid
    pool = Clients(clients, url, [request], workdir, "soak-client", count=frames // clients,
                    retry=True)
    monitor = HTTPSession()  # the sampler's; closed after every use
    samples: List[Dict] = []
    probes: Dict[int, Dict] = {}

    def fail(msg: str):
        raise SoakError(f"{msg}\n--- supervisor log ({log_path}), tail ---\n{_tail(log_path)}")

    def sample(frame: int) -> None:
        try:
            pid = monitor.get(url + "/health", timeout=30).json()["pid"]
            rss = rss_mb(pid)
            stats = monitor.get(url + "/stats", timeout=30).json()
        except TimeoutError:
            fail("/health or /stats not answered in 30 s")
        except (ConnectionError, http.client.HTTPException):
            return  # a recycle between the answer and the sample
        finally:
            monitor.close()
        if rss is None:
            return
        if pid not in probes:
            probes[pid] = _card_probe(sup.pid, cuda)
        samples.append({"frame": frame, "pid": pid, "rss_mb": round(rss, 1),
                        "gpu_vram_mb": stats.get("current_gpu_vram_mb")})

    def on_answer(answered: int) -> None:
        if answered % sample_every == 0:
            sample(answered)

    def supervisor_gone() -> Optional[str]:
        if sup.poll() is None:
            return None
        return f"the supervisor exited with {sup.returncode}"

    try:
        pool.start()
        try:
            rows = pool.wait(on_answer, supervisor_gone)
        except SoakError as e:
            fail(str(e))
        result["clients_imported_torch"] = any(r["torch_imported"] for r in rows)
        answers_rows = [r["rows"] for r in rows]
        result["answered"] = sum(len(r) for r in answers_rows)
        result["faces_answered"] = sum(
            json.loads(body)["faces_detected"] for r in answers_rows for _, _, body in r)
        if result["answered"] != frames:
            fail(f"{result['answered']} of {frames} requests answered")
        # the last answer may have reached --max_requests: a worker that
        # answers nothing but /finalize is then starting
        t_fin = time.monotonic()
        while True:
            try:
                r = monitor.post(url + "/finalize", json={}, timeout=ANSWER_TIMEOUT_S)
                break
            except (ConnectionError, http.client.HTTPException):
                if sup.poll() is not None or time.monotonic() - t_fin > STALL_S:
                    fail("/finalize found no worker")
                time.sleep(RETRY_S)
        if r.status_code != 200:
            fail(f"/finalize answered {r.status_code}: {r.text[:2000]}")
        session_dir = os.path.join(output_dir, SESSION)
        with open(os.path.join(session_dir, "session.json")) as f:
            result["statistics"] = json.load(f)["statistics"]
        with open(os.path.join(session_dir, "attendance.json")) as f:
            result["attendance"] = sorted(
                r["student_id"] for r in json.load(f)["recognized"])
        monitor.close()
        sup.send_signal(signal.SIGTERM)
        try:
            result["supervisor_rc"] = sup.wait(timeout=STOP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"the supervisor did not return within {STOP_TIMEOUT_S:.0f} s of SIGTERM")
        workers.stop()
        t_stop = time.monotonic()
        while any(_alive(p) for p in workers.first_seen) and time.monotonic() - t_stop < 10:
            time.sleep(POLL_S)
        left = [p for p in workers.first_seen if _alive(p)]
        if left:
            fail(f"workers {left} outlived their supervisor")
        if cuda:
            # a dead process's CUDA context is torn down asynchronously: wait
            # up to 10 s for memory.used to come back, and say how long
            before = result["card_used_mb_before"]
            while True:
                after = card_used_mb()
                if abs(after - before) <= 0.01 * before or time.monotonic() - t_stop > 10:
                    break
                time.sleep(0.25)
            result["card_used_mb_after"] = after
            result["card_release_s"] = time.monotonic() - t_stop
    finally:
        monitor.close()
        workers.stop()
        pool.close()
        if sup.poll() is None:
            sup.terminate()
            try:
                sup.wait(timeout=30)
            except subprocess.TimeoutExpired:
                sup.kill()
                sup.wait(timeout=30)
        for pid in workers.first_seen:
            if _alive(pid):
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        log.close()

    report = summarize(samples, frames, max_requests)
    report.update(result)
    report["payload_bytes"] = _payload_bytes(request)
    report["answers"] = answers_rows
    report["workers"] = _timings(workers, answers_rows)
    timings = {w["pid"]: w for w in report["workers"]}
    launched = launch_reports(log_path)
    for w in report["workers"]:
        w["probe"] = probes.get(w["pid"])
        line = launched.get(w["pid"], {})
        w["steps"], w["launches"] = line.get("steps"), line.get("launches")
    for gen in report["generations"]:
        gen.update({k: v for k, v in timings.get(gen["pid"], {}).items()
                    if k not in ("pid", "probe", "steps", "launches")})
        vram = [s["gpu_vram_mb"] for s in samples if s["pid"] == gen["pid"]]
        gen["gpu_vram_first_mb"], gen["gpu_vram_last_mb"] = vram[0], vram[-1]
    return report


def _timings(workers: _Workers, answers_rows) -> List[Dict]:
    """Per worker, in spawn order: its pid, the answers it gave (each
    answer goes to the last worker first seen before it: the supervisor
    starts the next worker only after the last one exited), their p50,
    start seconds, the downtime before its first answer and, but for the
    last worker (stopped by SIGTERM), the drain after its last answer; when
    it was first seen and seen gone, in seconds from the supervisor's
    start."""
    order = workers.order()
    seen = [workers.first_seen[p] for p in order]
    got: Dict[int, List] = {p: [] for p in order}
    for rows in answers_rows:
        for t, ms, _ in rows:
            i = int(np.searchsorted(seen, t, side="right")) - 1
            if i < 0:
                raise SoakError(f"an answer at {t} came before any worker was seen")
            got[order[i]].append((t, ms))
    out: List[Dict] = []
    prev_last = None
    for pid in order:
        ts = sorted(t for t, _ in got[pid])
        recycled = pid != order[-1] and pid in workers.gone
        out.append({
            "pid": pid,
            "seen_s": workers.first_seen[pid] - workers.t0,
            "gone_s": workers.gone[pid] - workers.t0 if pid in workers.gone else None,
            "requests": len(ts),
            "request_p50_ms": float(np.percentile([ms for _, ms in got[pid]], 50)) if ts else None,
            "start_s": ts[0] - workers.first_seen[pid] if ts else None,
            "downtime_s": ts[0] - prev_last if ts and prev_last is not None else None,
            "drain_s": workers.gone[pid] - ts[-1] if ts and recycled else None,
        })
        prev_last = ts[-1] if ts else prev_last
    return out


def check_soak(report: Dict) -> List[str]:
    """What a finished soak must show; each failure as a line. At least
    `MIN_GENERATIONS` workers with distinct pids that answered frames, each
    sampled twice and each with its launch line, which counts at least one
    step; each later generation's first RSS within 10% of the first
    generation's (the reset); RSS growth per request below half the
    request's payload (the bound of tests/test_serving_leak.py, taken as
    there: the least growth per request over a generation's intervals
    between samples, so that a leak shows in every interval and a one-off
    step, such as the worker's warm-up, in one); on a card, memory.used after the supervisor exits
    within 1% of before it started, each later generation's first memory.used less than half a
    worker's footprint above the first's (the previous worker released the
    card), and the supervisor holding no device file and no device memory.
    The session's statistics must hold every answer of every generation:
    total_faces_detected the sum of the answers' faces_detected and
    total_frames_processed the last frame number each client sent (the
    reference's field is the client's frame counter, not a count)."""
    bad = []
    stats = report["statistics"]
    # a worker started by the last answer's recycle may answer only /finalize
    serving = [w for w in report["workers"] if w["requests"]]
    if stats["total_faces_detected"] != report["faces_answered"]:
        bad.append(f"session.json counts {stats['total_faces_detected']} faces, the answers "
                   f"{report['faces_answered']}")
    if stats["total_frames_processed"] != report["frames_sent"] // report["clients"]:
        bad.append(f"session.json's total_frames_processed is "
                   f"{stats['total_frames_processed']}, the clients' last frame "
                   f"{report['frames_sent'] // report['clients']}")
    gens = report["generations"]
    pids = [w["pid"] for w in serving]
    if len(pids) < MIN_GENERATIONS or len(set(pids)) != len(pids):
        bad.append(f"{len(pids)} worker generations {pids}, want >= {MIN_GENERATIONS} "
                   f"distinct pids")
    for w in serving:
        if w.get("steps") is None:
            bad.append(f"worker {w['pid']} printed no launch line")
        elif w["steps"] < 1:
            bad.append(f"worker {w['pid']} answered {w['requests']} requests in no step")
    unsampled = set(pids) - {g["pid"] for g in gens}
    if unsampled:
        bad.append(f"workers {sorted(unsampled)} were never sampled")
    payload_mb = report["payload_bytes"] / 2 ** 20
    by_pid: Dict[int, List[Dict]] = {}
    for s in report["samples"]:
        by_pid.setdefault(s["pid"], []).append(s)
    for g in gens:
        rows = by_pid[g["pid"]]
        if len(rows) < 2:
            bad.append(f"generation {g['pid']}: {len(rows)} sample(s), growth not measured")
            continue
        per_request = min((b["rss_mb"] - a["rss_mb"]) / (b["frame"] - a["frame"])
                          for a, b in zip(rows, rows[1:]))
        g["growth_per_request_mb"] = per_request
        if per_request >= payload_mb / 2:
            bad.append(f"generation {g['pid']}: RSS grew {per_request:.4f} MB a request, "
                       f"bound {payload_mb / 2:.4f} (half a {report['payload_bytes']} B payload)")
    if gens:
        first = gens[0]["rss_first_mb"]
        for g in gens[1:]:
            if abs(g["rss_first_mb"] - first) > 0.1 * first:
                bad.append(f"generation {g['pid']} starts at {g['rss_first_mb']} MB RSS, "
                           f"generation 1 at {first} (not within 10%)")
    if "card_used_mb_before" in report:
        before, after = report["card_used_mb_before"], report["card_used_mb_after"]
        if abs(after - before) > 0.01 * before:
            bad.append(f"card memory.used {after} MiB after the supervisor exited, "
                       f"{before} before it started")
        probes = [w["probe"] for w in report["workers"] if w["probe"]]
        if probes:
            footprint = probes[0]["card_used_mb"] - before
            for probe in probes[1:]:
                if probe["card_used_mb"] - probes[0]["card_used_mb"] > footprint / 2:
                    bad.append(f"memory.used {probe['card_used_mb']} MiB at a later "
                               f"generation's first sample, {probes[0]['card_used_mb']} at "
                               f"generation 1's: a worker did not release the card")
    sup = report["supervisor_pid"]
    for probe in (w["probe"] for w in report["workers"] if w["probe"]):
        if probe["supervisor_device_files"]:
            bad.append(f"the supervisor holds {probe['supervisor_device_files']} open")
        if any(app["pid"] == sup for app in probe.get("compute_apps", [])):
            bad.append("the supervisor holds device memory (nvidia-smi --query-compute-apps)")
    return bad


def pids_visible(report: Dict) -> bool:
    """Whether nvidia-smi's compute processes name any worker's pid (a
    container's pid namespace hides them)."""
    workers = report["workers"]
    listed = {a["pid"] for w in workers if w["probe"] for a in w["probe"].get("compute_apps", [])}
    return bool(listed & {w["pid"] for w in workers})


def write_report(path: str, example: Optional[Dict] = None,
                 deployment: Optional[Dict] = None) -> Dict:
    """Write the soak's report file: the example run's report at the top
    level (the example's keys first), the deployment run's under
    "deployment"; a run not given keeps what the file already holds.
    Per-request answers and the log's path stay out."""
    doc: Dict = {}
    if os.path.exists(path):
        with open(path) as f:
            doc = json.load(f)

    def stored(rep):
        return {k: v for k, v in rep.items() if k not in ("answers", "log")}

    if example is not None:
        doc = {**stored(example), **{k: v for k, v in doc.items() if k == "deployment"}}
    if deployment is not None:
        doc["deployment"] = stored(deployment)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    return doc


# --------------------------------------------------------------- example


def example_soak(frames: int = 300, max_requests: int = 120, port: Optional[int] = None,
                 device="cuda", workdir: Optional[str] = None) -> Dict:
    """`examples/recycle_soak.py`'s run: 3 students with seeded random
    embeddings, the ir_18 server (max_faces 8, batch_max 2), `frames`
    requests of one seeded 480x640 noise frame as base64 PNG to
    /process_frame from one client, RSS sampled every 10 answers."""
    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
    from facerecognitionpipeline_tpu_torch.serve.client import _encode_image_base64

    workdir = workdir or tempfile.mkdtemp(prefix="recycle_soak_")
    gallery_path = os.path.join(workdir, "g.pkl")
    rng = np.random.default_rng(0)
    gallery = GalleryManager(gallery_path=gallery_path, verbose=False, device="cpu")
    for i in range(3):
        emb = rng.normal(size=(2, 512)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        gallery.add_student(f"STU{i:04d}", f"Student {i}", emb)
    gallery.save()
    frame = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    return run_recycle_soak(
        ["--gallery_path", gallery_path, *EXAMPLE_SERVER],
        {"path": "/process_frame", "json": {"frame": _encode_image_base64(frame)}},
        frames, max_requests, device=device, workdir=workdir, port=port,
    )
