"""The recycle soak (`serve/soak.py`) and the supervised server CLI.

(a) `summarize` on the JAX example's own samples gives its report's block.
(b) The JAX package's fake-`Popen` supervisor test, on both packages'
    `_supervise`: the same command sequences apart from the module name,
    and the handoff state file consumed.
(c) One real supervised CLI on the CPU through `run_recycle_soak`: three
    worker generations, each exiting after its drain, the session resumed
    across them, the supervisor gone after SIGTERM with no child left.
(d) A request accepted before the drain and answered after the recycle's
    flush still reaches session.json (the port's repair of the handoff).
(e) `check_soak` and the attribution of answers to workers, on made-up
    runs.
(f) The launch line a CLI process prints on its way out, and the idle
    keep-alive timeout of a recycling worker, as the JAX server's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from facerecognitionpipeline_tpu.serve import server as jserver
from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
from facerecognitionpipeline_tpu_torch.serve import server as tserver
from facerecognitionpipeline_tpu_torch.serve import soak
from facerecognitionpipeline_tpu_torch.serve.client import _encode_image_base64
from tests.test_torch_port_server import Side, _png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_REPORT = os.path.join(REPO, "reports", "serving_recycle_soak.json")


# ------------------------------------------------------------ (a) summarize


def test_summarize_rebuilds_the_jax_report():
    with open(JAX_REPORT) as f:
        rep = json.load(f)
    got = soak.summarize(rep["samples"], rep["frames_sent"], rep["max_requests"])
    assert got == rep
    assert [g["n_samples"] for g in got["generations"]] == [12, 11, 6]


TORCH_REPORT = os.path.join(REPO, "reports", "serving_recycle_soak_torch.json")
EXAMPLE_KEYS = ("pid", "n_samples", "rss_first_mb", "rss_last_mb", "growth_mb")


@pytest.mark.parametrize("run", ["example", "deployment"])
def test_committed_report_meets_the_bounds(run):
    """reports/serving_recycle_soak_torch.json (`chip_smoke.py --soak-only
    all` on the card): the example's keys, its block rebuilt from its own
    samples, every bound of check_soak, the card named beside it."""
    with open(TORCH_REPORT) as f:
        rep = json.load(f)
    rep = rep if run == "example" else rep["deployment"]
    assert soak.check_soak(rep) == [] and rep["failures"] == []
    block = soak.summarize(rep["samples"], rep["frames_sent"], rep["max_requests"])
    assert [{k: g[k] for k in EXAMPLE_KEYS} for g in rep["generations"]] == block["generations"]
    assert "H100" in rep["card"] and not rep["clients_imported_torch"]
    assert rep["answered"] == rep["frames_sent"]
    assert len({w["pid"] for w in rep["workers"] if w["requests"]}) >= 3
    # the sampler opens a connection per sample: no idle client held a drain
    drains = [w["drain_s"] for w in rep["workers"] if w["drain_s"] is not None]
    assert len(drains) >= 2 and all(0 < d < 10 for d in drains)
    serving = [w for w in rep["workers"] if w["requests"]]
    assert 0 < sum(w["steps"] for w in serving) <= rep["answered"]
    if run == "example":
        assert (rep["frames_sent"], rep["max_requests"], rep["clients"]) == (300, 120, 1)
    else:
        assert (rep["frames_sent"], rep["max_requests"], rep["clients"]) == (1200, 400, 2)
        assert rep["attendance"] == rep["enrolled"]
        per_step = {"crop_resize": 3, "warp_patches": 1, "gallery_topk": 0,
                    "gallery_topk_int8": 1, "gallery_topk_f32": 0, "nms_fixpoint": 3}
        assert rep["direct_launches"] == {k: 3 * v for k, v in per_step.items()}
        # every worker's own launches: K1 x3, K2 x1, K4 x1, K5 x3 a step
        for w in serving:
            assert w["launches"] == {k: v * w["steps"] for k, v in per_step.items()}
        assert rep["worker_launches"] == {
            k: v * rep["worker_steps"] for k, v in per_step.items()}


def test_summarize_keeps_the_order_pids_first_appear_in():
    samples = [{"frame": 10 * i, "pid": pid, "rss_mb": 100.0 + i}
               for i, pid in enumerate([7, 7, 3, 3, 3, 9])]
    gens = soak.summarize(samples, 60, 20)["generations"]
    assert [(g["pid"], g["n_samples"], g["growth_mb"]) for g in gens] == [
        (7, 2, 1.0), (3, 3, 2.0), (9, 1, 0.0)]


# ----------------------------------------------------- (b) the supervisor


def _fake_supervise(mod, out_dir, monkeypatch, writes=(1, 2, 3)):
    """Run `mod._supervise` over fake workers that exit 75, 75 and 0; the
    workers numbered in `writes` leave a handoff state file naming
    sess<n>. Returns (rc, commands)."""
    calls = []
    codes = iter([mod.RECYCLE_EXIT_CODE, mod.RECYCLE_EXIT_CODE, 0])

    class FakeProc:
        def __init__(self, rc):
            self._rc = rc

        def wait(self):
            return self._rc

        def poll(self):
            return self._rc

        def terminate(self):  # pragma: no cover - signal path
            pass

    def fake_popen(cmd):
        calls.append(cmd)
        if len(calls) in writes:
            with open(os.path.join(out_dir, ".recycle_state.json"), "w") as f:
                json.dump({"session_name": f"sess{len(calls)}"}, f)
        return FakeProc(next(codes))

    monkeypatch.setattr(subprocess, "Popen", fake_popen)
    argv = ["--output_dir", out_dir, "--max_requests", "5"]
    rc = mod._supervise(argv, mod.build_parser().parse_args(argv))
    return rc, calls


def test_supervisor_respawns_with_resume_as_the_jax_one(tmp_path, monkeypatch):
    runs = {}
    for name, mod in (("jax", jserver), ("torch", tserver)):
        out_dir = str(tmp_path / name)
        os.makedirs(out_dir)
        # a state file left by an earlier supervisor run is dropped first
        with open(os.path.join(out_dir, ".recycle_state.json"), "w") as f:
            json.dump({"session_name": "stale"}, f)
        rc, calls = _fake_supervise(mod, out_dir, monkeypatch)
        assert rc == 0 and len(calls) == 3
        assert "--_worker" in calls[0] and "--_resume_session" not in calls[0]
        assert calls[1][calls[1].index("--_resume_session") + 1] == "sess1"
        assert calls[2][calls[2].index("--_resume_session") + 1] == "sess2"
        runs[name] = [[a.replace(out_dir, "<out>") for a in c] for c in calls]
    jax_module = "facerecognitionpipeline_tpu.serve.server"
    torch_module = "facerecognitionpipeline_tpu_torch.cli.face_recognition_server"
    assert all(c[:3] == [sys.executable, "-m", torch_module] for c in runs["torch"])
    assert [[jax_module if a == torch_module else a for a in c]
            for c in runs["torch"]] == runs["jax"]


def test_supervisor_consumes_the_state_file(tmp_path, monkeypatch):
    """Only the first worker leaves a state file: the second resumes its
    session, the third resumes none (a state file is read once), in both
    packages."""
    runs = {}
    for name, mod in (("jax", jserver), ("torch", tserver)):
        out_dir = str(tmp_path / name)
        os.makedirs(out_dir)
        rc, calls = _fake_supervise(mod, out_dir, monkeypatch, writes=(1,))
        assert rc == 0 and len(calls) == 3
        assert calls[1][calls[1].index("--_resume_session") + 1] == "sess1"
        assert "--_resume_session" not in calls[2]
        assert not os.path.exists(os.path.join(out_dir, ".recycle_state.json"))
        runs[name] = [c[3:] for c in calls]
    assert [[a.replace(str(tmp_path / "torch"), "<out>") for a in c] for c in runs["torch"]] \
        == [[a.replace(str(tmp_path / "jax"), "<out>") for a in c] for c in runs["jax"]]


@pytest.mark.parametrize("mod", [jserver, tserver], ids=["jax", "torch"])
def test_supervisor_returns_the_first_code_that_is_not_a_recycle(tmp_path, monkeypatch, mod):
    calls = []

    class Proc:
        def wait(self):
            return 3

        def poll(self):
            return 3

    monkeypatch.setattr(subprocess, "Popen", lambda cmd: calls.append(cmd) or Proc())
    argv = ["--output_dir", str(tmp_path), "--max_requests", "2"]
    assert mod._supervise(argv, mod.build_parser().parse_args(argv)) == 3
    assert len(calls) == 1


# ------------------------------------------------ (c) the CLI on the CPU


def test_supervised_cli_recycles_on_the_cpu(tmp_path):
    """--use_cpu --architecture ir_micro --max_faces 2 --batch_max 1
    --max_requests 2, five requests of one client: three workers."""
    gallery_path = str(tmp_path / "g.pkl")
    gallery = GalleryManager(gallery_path, verbose=False, device="cpu")
    rng = np.random.default_rng(0)
    gallery.add_student("STU0000", "Student 0", rng.normal(size=(2, 512)).astype(np.float32))
    gallery.save()
    frame = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    rep = soak.run_recycle_soak(
        ["--gallery_path", gallery_path, "--architecture", "ir_micro",
         "--max_faces", "2", "--batch_max", "1"],
        {"path": "/process_frame", "json": {"frame": _encode_image_base64(frame)}},
        frames=5, max_requests=2, sample_every=1, device="cpu",
        workdir=str(tmp_path / "soak"),
    )
    workers = rep["workers"]
    pids = [w["pid"] for w in workers]
    assert len(set(pids)) == 3
    # every worker /health named was one the supervisor spawned, and /health
    # named each of them
    assert {s["pid"] for s in rep["samples"]} == set(pids)
    assert [w["requests"] for w in workers] == [2, 2, 1]
    # each worker's launch line, the last one's printed at SIGTERM: one step
    # a request (batch_max 1), no kernel launched on the CPU
    assert [w["steps"] for w in workers] == [2, 2, 1]
    assert all(w["launches"] == dict.fromkeys(tserver.launch_counts(), 0) for w in workers)
    for before, after in zip(workers, workers[1:]):
        # the worker exited after its drain, and only then came the next
        # (gone_s is the time of the poll that found it gone, a poll or two
        # late on a loaded host; seen_s the process's own start time)
        assert before["drain_s"] is not None
        assert before["gone_s"] < after["seen_s"] + 1.0
        # no idle kept-alive connection held the drain (the sampler opens one
        # connection per sample)
        assert before["drain_s"] < 10
        assert after["downtime_s"] >= after["start_s"] > 0
    assert rep["answered"] == 5 and rep["statistics"]["total_frames_processed"] == 5
    assert rep["statistics"]["total_faces_detected"] == rep["faces_answered"]
    assert rep["supervisor_rc"] is not None
    assert not any(soak._alive(p) for p in pids + [rep["supervisor_pid"]])
    assert not rep["clients_imported_torch"]
    assert all(w["probe"]["supervisor_device_files"] == [] for w in workers)
    with open(rep["log"]) as f:
        log = f.read()
    assert log.count("[recycle] starting worker generation") == 3
    assert log.count("resuming session 'soak'") == 2


def test_soak_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="split evenly"):
        soak.run_recycle_soak([], {"path": "/", "data": b"", "headers": {}}, frames=5,
                              max_requests=2, clients=2, device="cpu")


# --------------------------------------- (d) answered during the drain


def test_requests_answered_during_the_drain_reach_session_json(tmp_path):
    """max_requests=2: the second frame flushes the counters and starts the
    drain; a third request, accepted before the listener closed, is answered
    during it. The worker's shutdown (main() calls it once the handler
    threads are joined) must flush again, or the next worker resumes
    without the third frame's faces."""
    side = Side("torch", tmp_path / "torch", max_requests=2)
    try:
        assert side.call("POST", "/init_session", json={"session_name": "r"})[0] == 200
        for i in (1, 2):
            assert side.call("POST", "/process_frame", **_png(i))[0] == 200
        side.thread.join(timeout=10)
        assert not side.thread.is_alive()
        with open(tmp_path / "torch" / "sessions" / "r" / "session.json") as f:
            flushed = json.load(f)["statistics"]
        # the in-flight request, served by its handler thread
        frame = np.random.default_rng(3).integers(0, 256, (120, 160, 3), dtype=np.uint8)
        body = side.srv.process_full_frame(frame, 3, "2026-01-01T00:00:03")
        side.srv.note_request_served()
    finally:
        side.close()
    with open(tmp_path / "torch" / "sessions" / "r" / "session.json") as f:
        stats = json.load(f)["statistics"]
    assert stats["total_frames_processed"] == 3
    assert stats["total_faces_detected"] == (
        flushed["total_faces_detected"] + body["faces_detected"])
    assert body["faces_detected"] > 0
    with open(tmp_path / "torch" / "sessions" / ".recycle_state.json") as f:
        assert json.load(f) == {"session_name": "r"}
    resumed = Side("torch", tmp_path / "torch")
    try:
        resumed.srv._create_session("r", resume=True)
        assert resumed.srv.total_faces_detected == stats["total_faces_detected"]
    finally:
        resumed.close()


# --------------------------------------------- (e) checks on made-up runs


class _FakeWorkers:
    t0 = 0.0

    def __init__(self, first_seen, gone):
        self.first_seen = first_seen
        self.gone = gone

    def order(self):
        return sorted(self.first_seen, key=self.first_seen.get)


def test_answers_go_to_the_worker_last_spawned_before_them():
    workers = _FakeWorkers({11: 1.0, 22: 20.0, 33: 40.0}, {11: 12.5, 22: 31.0})
    rows = [[[5.0, 10.0, "{}"], [6.0, 30.0, "{}"], [25.0, 20.0, "{}"]],
            [[12.0, 40.0, "{}"], [45.0, 50.0, "{}"]]]
    got = soak._timings(workers, rows)
    assert [w["pid"] for w in got] == [11, 22, 33]
    assert [w["requests"] for w in got] == [3, 1, 1]
    assert got[0]["request_p50_ms"] == 30.0
    assert got[0]["start_s"] == 4.0 and got[0]["downtime_s"] is None
    assert got[0]["drain_s"] == 0.5
    assert got[1]["downtime_s"] == 13.0 and got[1]["start_s"] == 5.0
    assert got[1]["drain_s"] == 6.0
    # the last worker was stopped, not recycled: no drain
    assert got[2]["drain_s"] is None and got[2]["gone_s"] is None


def _made_up_report(**over):
    samples = []
    for g, pid in enumerate((11, 22, 33)):
        for k in range(3):
            samples.append({"frame": 30 * g + 10 * (k + 1), "pid": pid,
                            "rss_mb": 1000.0 + 0.1 * k})
    rep = soak.summarize(samples, 90, 30)
    probe = {"supervisor_device_files": [], "card_used_mb": 3000.0,
             "compute_apps": [{"pid": 4242, "used_mb": 2000.0}]}
    rep.update({
        "clients": 1, "payload_bytes": 614_400, "faces_answered": 90,
        "statistics": {"total_frames_processed": 90, "total_faces_detected": 90},
        "workers": [{"pid": p, "requests": 30, "probe": dict(probe), "steps": 30,
                     "launches": {"crop_resize": 90}} for p in (11, 22, 33)]
        + [{"pid": 44, "requests": 0, "probe": None, "steps": None,  # only /finalize
            "launches": None}],
        "supervisor_pid": 7, "card_used_mb_before": 1000.0, "card_used_mb_after": 1005.0,
    })
    rep.update(over)
    return rep


def test_check_soak_passes_a_run_that_meets_every_bound():
    assert soak.check_soak(_made_up_report()) == []
    assert not soak.pids_visible(_made_up_report())


@pytest.mark.parametrize("fault,expect", [
    ("two_generations", "2 worker generations"),
    ("no_reset", "not within 10%"),
    ("growth", "half a 614400 B payload"),
    ("one_sample", "1 sample(s)"),
    ("card_after", "after the supervisor exited"),
    ("not_released", "did not release the card"),
    ("supervisor_files", "the supervisor holds ['/dev/nvidiactl'] open"),
    ("supervisor_memory", "the supervisor holds device memory"),
    ("faces", "session.json counts 80 faces"),
    ("frames", "total_frames_processed is 60"),
    ("no_launch_line", "worker 22 printed no launch line"),
    ("no_step", "worker 33 answered 30 requests in no step"),
])
def test_check_soak_names_each_fault(fault, expect):
    rep = _made_up_report()
    if fault == "two_generations":
        rep["workers"] = rep["workers"][:2]
        rep = {**rep, **soak.summarize(rep["samples"][:6], 90, 30)}
    elif fault == "no_reset":
        for s in rep["samples"][6:]:
            s["rss_mb"] += 200
        rep = {**rep, **soak.summarize(rep["samples"], 90, 30)}
    elif fault == "growth":
        for k, s in enumerate(rep["samples"][3:6]):
            s["rss_mb"] += 3.0 * k  # 0.3 MB a request against 0.29
        rep = {**rep, **soak.summarize(rep["samples"], 90, 30)}
    elif fault == "one_sample":
        rep = {**rep, **soak.summarize(rep["samples"][:-2], 90, 30)}
    elif fault == "card_after":
        rep["card_used_mb_after"] = 1020.0
    elif fault == "not_released":
        rep["workers"][2]["probe"] = {**rep["workers"][2]["probe"], "card_used_mb": 4100.0}
    elif fault == "supervisor_files":
        rep["workers"][1]["probe"] = {**rep["workers"][1]["probe"],
                                      "supervisor_device_files": ["/dev/nvidiactl"]}
    elif fault == "supervisor_memory":
        rep["workers"][0]["probe"] = {**rep["workers"][0]["probe"],
                                      "compute_apps": [{"pid": 7, "used_mb": 500.0}]}
    elif fault == "faces":
        rep["statistics"] = {**rep["statistics"], "total_faces_detected": 80}
    elif fault == "frames":
        rep["statistics"] = {**rep["statistics"], "total_frames_processed": 60}
    elif fault == "no_launch_line":
        rep["workers"][1] = {**rep["workers"][1], "steps": None, "launches": None}
    elif fault == "no_step":
        rep["workers"][2] = {**rep["workers"][2], "steps": 0}
    bad = soak.check_soak(rep)
    assert len(bad) == 1 and expect in bad[0], bad


def test_growth_is_the_least_over_the_intervals_between_samples():
    """A one-off step in one interval (the worker's warm-up, an arena the
    allocator extends) is no growth per request; a rise in every interval
    is."""
    rep = _made_up_report()
    for s in rep["samples"][4:6]:
        s["rss_mb"] += 3.5  # generation 2: +3.5 MB between its first two samples only
    rep["samples"][8]["rss_mb"] += 3.5  # generation 3: +3.5 MB in its last interval only
    rep = {**rep, **soak.summarize(rep["samples"], 90, 30)}
    assert soak.check_soak(rep) == []
    assert rep["generations"][1]["growth_per_request_mb"] == pytest.approx(0.01)
    assert rep["generations"][2]["growth_per_request_mb"] == pytest.approx(0.01)
    for k, s in enumerate(rep["samples"][6:9]):
        s["rss_mb"] += 3.5 * k  # generation 3: 0.35 MB a request in every interval
    bad = soak.check_soak({**rep, **soak.summarize(rep["samples"], 90, 30)})
    assert len(bad) == 1 and "generation 33: RSS grew" in bad[0], bad


def test_rss_and_process_state_of_this_process():
    assert soak.rss_mb(os.getpid()) > 10
    assert soak._alive(os.getpid())
    assert soak.rss_mb(2 ** 22 + 12345) is None and not soak._alive(2 ** 22 + 12345)


def test_a_childs_threads_are_not_children(monkeypatch):
    """The card's machine lists a child's threads in the parent's /proc
    children file: only the child counts."""
    import builtins
    import io

    child = subprocess.Popen([sys.executable, "-c", (
        "import threading, time\n"
        "[threading.Thread(target=time.sleep, args=(30,), daemon=True).start() for _ in range(3)]\n"
        "print('up', flush=True)\n"
        "time.sleep(30)\n")], stdout=subprocess.PIPE, text=True)
    try:
        assert child.stdout.readline().strip() == "up"
        tasks = sorted(os.listdir(f"/proc/{child.pid}/task"), key=int)
        assert len(tasks) == 4 and tasks[0] == str(child.pid)
        real_open = builtins.open
        children = f"/proc/{os.getpid()}/task/{os.getpid()}/children"
        monkeypatch.setattr(builtins, "open", lambda path, *a, **k: (
            io.StringIO(" ".join(tasks) + " ") if path == children else real_open(path, *a, **k)))
        assert soak._children(os.getpid()) == [child.pid]
    finally:
        child.kill()
        child.wait(timeout=10)


# ------------------------------------ (f) launch line and keep-alive timeout


def test_launch_report_counts_from_the_ready_server(tmp_path):
    """A server's launch report counts the kernels launched since it was
    ready and the steps its batcher dispatched; `launch_reports` reads the
    line back by pid."""
    from facerecognitionpipeline_tpu_torch.ops import crop_kernel, nms_kernel

    side = Side("torch", tmp_path)
    try:
        assert side.srv.launch_report() == {
            "pid": os.getpid(), "steps": 0,
            "launches": dict.fromkeys(tserver.launch_counts(), 0)}
        assert side.call("POST", "/init_session", json={"session_name": "l"})[0] == 200
        assert side.call("POST", "/process_frame", **_png(1))[0] == 200
        crop_kernel.LAUNCHES.add(3)
        nms_kernel.LAUNCHES.add(3)
        try:
            report = side.srv.launch_report()
        finally:
            crop_kernel.LAUNCHES.add(-3)
            nms_kernel.LAUNCHES.add(-3)
    finally:
        side.close()
    assert report["steps"] == 1
    assert report["launches"] == {**dict.fromkeys(tserver.launch_counts(), 0),
                                  "crop_resize": 3, "nms_fixpoint": 3}
    log = tmp_path / "log"
    log.write_text("Engine ready.\n"
                   + tserver.LAUNCH_LINE + json.dumps({**report, "steps": 0}) + "\n"
                   + "[recycle] starting worker generation 2\n"
                   + tserver.LAUNCH_LINE + json.dumps(report) + "\n")
    assert soak.launch_reports(str(log)) == {os.getpid(): report}
    assert soak.LAUNCH_LINE == tserver.LAUNCH_LINE


@pytest.mark.parametrize("mod", [jserver, tserver], ids=["jax", "torch"])
def test_a_recycling_worker_closes_idle_connections_after_30_s(mod):
    """In recycle mode a handler's socket times out after KEEPALIVE_IDLE_S,
    30 s, in both packages: an idle kept-alive client holds a drain for at
    most that long. Without --max_requests idle connections stay open."""
    import types

    recycling = mod.make_handler(types.SimpleNamespace(max_requests=5))
    assert recycling.KEEPALIVE_IDLE_S == 30.0 and recycling.timeout == 30.0
    assert mod.make_handler(types.SimpleNamespace(max_requests=None)).timeout is None
