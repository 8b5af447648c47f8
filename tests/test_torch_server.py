"""The port's serving layer (``lightx2v_tpu_torch.server``) on the CPU, held
against ``lightx2v_tpu.server`` in one process.

- Endpoint parity: both packages' services serve the same stub runner
  (``config``, ``set_inputs``, ``run_pipeline`` held at its start by an
  Event) through their own ``ApiServer``; every step of one scripted session
  (submit, list, status, result, 404 / 422 / 403, upload, stop when idle,
  per-task stop while pending and while processing, download, metrics and
  metadata) gives the same status code and JSON keys on both.
- Schema parity: a table of bodies through pydantic's ``TaskRequest`` and
  the port's ``TaskRequest.from_dict``: the same accept / 422 decision and
  the same ``model_dump()``.
- Two replicas on the stub, and ``mesh_shape`` with two replicas refused.
- One tiny real runner (``configs/wan_t2v_synthetic_smoke.json``, bf16,
  ``device: cpu``) behind HTTP: each request's frames equal a fresh
  runner's bit for bit, and the served latents carry no autograd graph.
- The stage subservices round-trip to the runner's own outputs, and the
  enhancer service's prompt is the one the runner encodes.
- A runner serves twice as it serves once: each of the seven
  ``--model_cls`` runners at a tiny size, run with seed a, then seed b and
  another prompt, equals a fresh runner's run at seed b bit for bit.
- The card's video writer: ``write_mjpeg_mp4``'s boxes parsed, every JPEG
  decoded by PIL within JPEG's error of the input (mean abs <= 3 of 255).

Every wait has a timeout (``WAIT``)."""

import http.client
import io
import json
import os
import struct
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SMOKE = str(ROOT / "configs/wan_t2v_synthetic_smoke.json")
WAIT = 30.0  # seconds: the longest any one wait here may take


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _req(port, method, path, body=None, raw=None):
    """(status code, JSON body or None) of one request to 127.0.0.1."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
    conn.request(method, path, body=data, headers={"Content-Type": "application/json",
                                                   "Content-Length": str(len(data or b""))})
    r = conn.getresponse()
    payload = r.read()
    conn.close()
    try:
        return r.status, json.loads(payload)
    except ValueError:
        return r.status, None


def _until(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


class StubRunner:
    """A runner without a model: ``run_pipeline`` waits at its start until
    ``release`` is set, then stops (the package's ``TaskStopped``) if its
    task was asked to, else writes a small file at the save path."""

    def __init__(self, stopped, release=None):
        self.config = {"device": "cpu", "model_cls": "wan2.1"}
        self.stopped = stopped
        self.stop_event = None
        self.entered = threading.Event()
        self.release = release or threading.Event()
        self.inputs = []

    def set_inputs(self, inputs):
        self.inputs.append(dict(inputs))
        self.config.update(inputs)

    def run_pipeline(self):
        self.entered.set()
        if not self.release.wait(WAIT):
            raise AssertionError("the stub was never released")
        if self.stop_event is not None and self.stop_event.is_set():
            raise self.stopped("task stop requested")
        Path(self.config["save_video_path"]).write_bytes(b"\x00\x00\x00\x08mdat")


def _packages():
    from lightx2v_tpu.runners.base_runner import TaskStopped as JStopped
    from lightx2v_tpu.server.api import ApiServer as JApi
    from lightx2v_tpu.server.service import VideoGenerationService as JService
    from lightx2v_tpu_torch.runners.base_runner import TaskStopped as TStopped
    from lightx2v_tpu_torch.server.api import ApiServer as TApi
    from lightx2v_tpu_torch.server.service import VideoGenerationService as TService

    return {"jax": (JService, JApi, JStopped), "torch": (TService, TApi, TStopped)}


def _session(service_cls, api_cls, stopped, out: Path):
    """One scripted session against a live server: [(step, code, keys, status-like values)]."""
    stub = StubRunner(stopped)
    cfg = {"model_cls": "wan2.1", "task": "t2v", "infer_steps": 4, "dim": 5120, "mm_config": {"mm_type": "Default"}}
    service = service_cls(lambda: stub, output_root=str(out), server_config=cfg)
    srv = api_cls(service, host="127.0.0.1", port=0, output_root=str(out))
    srv.serve_background()
    port, log = srv.port, []

    def step(name, method, path, body=None, raw=None, values=()):
        code, js = _req(port, method, path, body, raw)
        log.append((name, code, sorted(js) if isinstance(js, dict) else None,
                    tuple(js.get(v) for v in values) if isinstance(js, dict) else None))
        return js

    def status(tid):
        return service.get(tid).status

    try:
        step("status idle", "GET", "/v1/service/status", values=("service_status", "task_id"))
        step("stop idle", "DELETE", "/v1/tasks/running", values=("stop_status", "reason"))
        t1 = step("submit 1", "POST", "/v1/tasks", {"prompt": "a", "seed": 1, "save_video_path": "one.mp4"},
                  values=("task_status",))["task_id"]
        _until(stub.entered.is_set, "task 1 to start")
        step("status busy", "GET", "/v1/service/status", values=("service_status",))
        t2 = step("submit 2", "POST", "/v1/tasks", {"prompt": "b", "seed": "2", "options": {"tiny_vae": True}},
                  values=("task_status",))["task_id"]
        step("list", "GET", "/v1/tasks")
        step("status 1", "GET", f"/v1/tasks/{t1}/status", values=("status", "error"))
        step("status 2", "GET", f"/v1/tasks/{t2}/status", values=("status", "error"))
        step("result pending", "GET", f"/v1/tasks/{t2}/result")
        step("stop pending", "DELETE", f"/v1/tasks/{t2}", values=("stop_status", "reason"))
        step("stop processing", "DELETE", f"/v1/tasks/{t1}", values=("stop_status", "reason"))
        stub.release.set()
        _until(lambda: status(t1) == "stopped" and status(t2) == "stopped", "both stops")
        step("stop again", "DELETE", f"/v1/tasks/{t1}", values=("stop_status", "reason"))
        step("stop unknown", "DELETE", "/v1/tasks/NOPE-NOPE", values=("stop_status", "reason"))
        t3 = step("submit 3", "POST", "/v1/tasks", {"prompt": "c", "save_video_path": "../../escape.mp4"},
                  values=("task_status",))["task_id"]
        _until(lambda: status(t3) == "completed", "task 3")
        res = step("result 3", "GET", f"/v1/tasks/{t3}/result", values=("status", "download_path"))
        step("result stopped", "GET", f"/v1/tasks/{t1}/result")
        step("status unknown", "GET", "/v1/tasks/NOPE-NOPE/status")
        step("result unknown", "GET", "/v1/tasks/NOPE-NOPE/result")
        step("bad seed", "POST", "/v1/tasks", {"seed": "not-an-int"})
        step("bad prompt", "POST", "/v1/tasks", {"prompt": 5})
        step("bad json", "POST", "/v1/tasks", raw=b"{not json")
        step("traversal", "GET", "/v1/files/download/../../etc/passwd")
        step("missing file", "GET", "/v1/files/download/missing.mp4")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
        conn.request("GET", f"/v1/files/download/{res['download_path']}")
        r = conn.getresponse()
        log.append(("download", r.status, r.getheader("Content-Type"), r.read()))
        conn.close()
        up = step("upload", "POST", "/v1/files/upload?name=cond.png", raw=b"\x89PNG fake")
        log.append(("upload file", os.path.relpath(up["path"], out), Path(up["path"]).read_bytes(), None))
        step("upload empty", "POST", "/v1/files/upload?name=e.png", raw=b"")
        step("unknown post", "POST", "/v1/nope", {})
        step("unknown get", "GET", "/v1/nope")
        step("unknown delete", "DELETE", "/v1/nope")
        step("web ui", "GET", "/")
        m = step("metrics", "GET", "/v1/service/metrics",
                 values=("tasks_submitted", "tasks_completed", "tasks_failed", "tasks_stopped", "queue_depth",
                         "busy_replicas"))
        meta = step("metadata", "GET", "/v1/service/metadata", values=("model_cls", "task", "active_quant_scheme"))
        log.append(("metadata parts", sorted(meta["device"]), sorted(meta["defaults"]), sorted(meta["auto_config"])))
        log.append(("saved in root", os.path.dirname(service.get(t3).request.save_video_path) == str(out),
                    sorted(stub.inputs[-1]), None))
        return log, m
    finally:
        stub.release.set()
        srv.shutdown()


def test_endpoints_match_the_jax_server(tmp_path):
    logs = {}
    for name, (svc, api, stopped) in _packages().items():
        (tmp_path / name).mkdir()
        logs[name], metrics = _session(svc, api, stopped, tmp_path / name)
        assert metrics["last_task_seconds"] is not None
    jax_log, torch_log = logs["jax"], logs["torch"]
    assert [s[0] for s in torch_log] == [s[0] for s in jax_log]
    for j, t in zip(jax_log, torch_log):
        assert t == j, (t, j)
    codes = {s[0]: s[1] for s in torch_log}
    assert (codes["status unknown"], codes["bad seed"], codes["bad json"], codes["traversal"],
            codes["result pending"]) == (404, 422, 422, 403, 400)


# bodies: pydantic's lax-mode decisions on ints, bools, strings, Optionals and unknown keys
BODIES = [
    {}, {"prompt": "a cat", "seed": 3, "unknown_key": [1, 2]}, {"seed": "5"}, {"seed": " 5 "}, {"seed": "5.0"},
    {"seed": "1_000"}, {"seed": "5.5"}, {"seed": 5.0}, {"seed": 5.5}, {"seed": True}, {"seed": None},
    {"seed": ""}, {"seed": "1e3"}, {"seed": [5]}, {"infer_steps": None}, {"infer_steps": "4"},
    {"use_prompt_enhancer": "yes"}, {"use_prompt_enhancer": "Off"}, {"use_prompt_enhancer": 1},
    {"use_prompt_enhancer": 2}, {"use_prompt_enhancer": " true"}, {"prompt": 5}, {"prompt": None},
    {"task_id": None}, {"task_id": 7}, {"options": {"tiny_vae": True}}, {"options": []}, {"options": None},
    {"video_duration": "3"}, {"video_duration": 3.5}, {"num_fragments": 1e20}, {"target_video_length": "81"},
]


@pytest.mark.parametrize("body", BODIES, ids=[json.dumps(b) for b in BODIES])
def test_schema_matches_pydantic(body):
    from lightx2v_tpu.server.schema import TaskRequest as PydanticTask
    from lightx2v_tpu_torch.server.schema import TaskRequest

    try:
        want = PydanticTask(**body).model_dump()
    except Exception:
        want = None
    if want is None:
        with pytest.raises(ValueError):
            TaskRequest.from_dict(body)
    else:
        assert TaskRequest.from_dict(body).model_dump() == want


def test_two_replicas_on_the_stub(tmp_path):
    from lightx2v_tpu_torch.runners.base_runner import TaskStopped
    from lightx2v_tpu_torch.server.schema import TaskRequest
    from lightx2v_tpu_torch.server.service import VideoGenerationService

    release = threading.Event()
    stubs = []

    def factory():
        stubs.append(StubRunner(TaskStopped, release))
        return stubs[-1]

    service = VideoGenerationService(factory, output_root=str(tmp_path), num_replicas=2)
    try:
        recs = [service.submit(TaskRequest(prompt=f"clip {i}", save_video_path=f"r{i}.mp4", seed=i))
                for i in range(2)]
        _until(lambda: len(stubs) == 2 and all(s.entered.is_set() for s in stubs), "both replicas to start")
        st = service.status()
        assert st["service_status"] == "busy" and sorted(st["replicas"]) == ["0", "1"]
        release.set()
        _until(lambda: all(r.status == "completed" for r in recs), "both tasks")
        assert len(service._runners) == 2 and all((tmp_path / f"r{i}.mp4").exists() for i in range(2))
        assert sorted(s.inputs[0]["seed"] for s in stubs) == [0, 1]
    finally:
        release.set()
        service.shutdown()
    assert service.join(WAIT)


def test_mesh_shape_with_two_replicas_refused(tmp_path):
    from lightx2v_tpu_torch.server.service import VideoGenerationService

    with pytest.raises(NotImplementedError, match="item 14"):
        VideoGenerationService(lambda: None, output_root=str(tmp_path), num_replicas=2,
                               server_config={"mesh_shape": {"sp": 2}})


def _smoke_config(**extra):
    from lightx2v_tpu_torch import infer
    from lightx2v_tpu_torch.utils.config import set_config

    args = infer.build_parser().parse_args(["--model_cls", "wan2.1", "--config_json", SMOKE,
                                            "--synthetic_weights", "--device", "cpu"])
    cfg = set_config(args)
    cfg.update(extra)
    return cfg


@pytest.fixture(scope="module")
def tiny_runner():
    from lightx2v_tpu_torch import infer

    return infer.init_runner(_smoke_config())


def _fresh_frames(**inputs):
    from lightx2v_tpu_torch import infer

    return infer.init_runner(_smoke_config(**inputs)).run_pipeline(save_video=False)


def test_served_requests_equal_fresh_runs(tiny_runner, tmp_path, monkeypatch):
    """Two requests through HTTP on one loaded runner: each request's frames
    (as handed to the video writer, the PIL one here) equal a fresh runner's
    bit for bit; the latents carry no autograd graph."""
    from lightx2v_tpu_torch.server.api import ApiServer
    from lightx2v_tpu_torch.server.service import VideoGenerationService
    from lightx2v_tpu_torch.utils import media

    monkeypatch.setattr(media, "video_writer", lambda: None)
    r = tiny_runner
    frames, latents = {}, []
    save, run_dit = r.save_video, r.run_dit

    def capture(f, path):
        frames[os.path.basename(path)] = f
        save(f, path)

    def dit(*a, **kw):
        latents.append(run_dit(*a, **kw))
        return latents[-1]

    monkeypatch.setattr(r, "save_video", capture)
    monkeypatch.setattr(r, "run_dit", dit)
    service = VideoGenerationService(lambda: r, output_root=str(tmp_path), server_config=r.config)
    srv = ApiServer(service, host="127.0.0.1", port=0, output_root=str(tmp_path))
    srv.serve_background()
    try:
        asks = [("a red panda", 1, "p1.mp4"), ("a lighthouse in a storm", 2, "p2.mp4")]
        for prompt, seed, name in asks:
            code, body = _req(srv.port, "POST", "/v1/tasks", {"prompt": prompt, "seed": seed,
                                                               "save_video_path": name})
            assert code == 200
            _until(lambda: service.get(body["task_id"]).status in ("completed", "failed"), name)
            rec = service.get(body["task_id"])
            assert rec.status == "completed", rec.error
            assert {"encode_s", "dit_s", "decode_s", "save_s"} <= set(rec.timings)
            assert (tmp_path / name).stat().st_size > 1000
        m = service.metrics()
        assert set(m["last_stage_seconds"]) == {"Run Encoders", "Run DiT", "Run VAE Decoder", "Save video"}
    finally:
        srv.shutdown()
    for prompt, seed, name in asks:
        np.testing.assert_array_equal(frames[name], _fresh_frames(prompt=prompt, seed=seed))
    assert all(not lat.requires_grad and lat.grad_fn is None for lat in latents)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return json.loads(r.read())


def test_stage_subservices_round_trip(tiny_runner):
    """The text_encoder, vae and dit stage services (each its own runner on
    the smoke config, in this process) return the runner's own outputs."""
    from lightx2v_tpu_torch.server.subservices import (StageService, _build_handler, check_subservice,
                                                       decode_arrays, encode_arrays)

    r, prompt = tiny_runner, "a bamboo forest"
    services = {s: StageService(s, _build_handler(s, _smoke_config()), host="127.0.0.1", port=0)
                for s in ("text_encoder", "vae", "dit")}
    for s in services.values():
        s.serve_background()
    try:
        url = {s: f"http://127.0.0.1:{v.port}" for s, v in services.items()}
        assert all(check_subservice(u) for u in url.values())
        ctx = decode_arrays(_post(url["text_encoder"] + "/v1/text_encoder", {"prompt": prompt})["context"])
        np.testing.assert_array_equal(ctx["context"], r.text_encoder.infer([prompt]).float().numpy())

        lat = decode_arrays(_post(url["dit"] + "/v1/dit", {"prompt": prompt, "seed": 3})["latents"])["latents"]
        r.set_inputs({"prompt": prompt, "seed": 3})
        np.testing.assert_array_equal(lat, r.run_dit(r.run_input_encoder()).float().numpy())

        frames = decode_arrays(_post(url["vae"] + "/v1/vae", {"latents": encode_arrays({"latents": lat})})["frames"])
        np.testing.assert_array_equal(frames["frames"], r.run_vae_decoder(torch.from_numpy(lat)))
    finally:
        for s in services.values():
            s.shutdown()
    assert not check_subservice(url["vae"], timeout=1.0)


def test_stage_refusals():
    from lightx2v_tpu_torch.server.subservices import _build_handler

    with pytest.raises(NotImplementedError, match="item 18"):
        _build_handler("prompt_enhancer", _smoke_config())
    with pytest.raises(ValueError, match="unknown stage"):
        _build_handler("image_encoder", _smoke_config())


def test_prompt_enhancer_service(tiny_runner):
    """With ``use_prompt_enhancer`` and ``prompt_enhancer_url`` the runner
    encodes the service's prompt; a dead service, or no URL, leaves the raw
    prompt."""
    from lightx2v_tpu_torch.server.subservices import StageService
    from lightx2v_tpu_torch.utils.prompt_enhancer import enhance_via_service

    r, raw = tiny_runner, "a cat"
    enhanced = "a fluffy ginger cat napping on a sunlit windowsill, slow dolly in"
    svc = StageService("enhance", lambda p: {"prompt": enhanced if p["prompt"] == raw else ""},
                       host="127.0.0.1", port=0)
    svc.serve_background()
    url = f"http://127.0.0.1:{svc.port}"

    def context(url=None):
        r.config.update(prompt=raw, use_prompt_enhancer=True, prompt_enhancer_url=url)
        return r.run_input_encoder()["text_encoder_output"]["context"]

    try:
        assert enhance_via_service(raw, url) == enhanced
        torch.testing.assert_close(context(url), r.text_encoder.infer([enhanced]),
                                   rtol=0, atol=0)
    finally:
        svc.shutdown()
    assert enhance_via_service(raw, url, timeout=1.0) is None
    want = r.text_encoder.infer([raw])
    torch.testing.assert_close(context(url), want, rtol=0, atol=0)
    torch.testing.assert_close(context(), want, rtol=0, atol=0)
    r.config.update(use_prompt_enhancer=False)


def test_local_prompt_enhancer_refused():
    from lightx2v_tpu_torch.utils.prompt_enhancer import PromptEnhancer

    with pytest.raises(NotImplementedError, match="item 18"):
        PromptEnhancer()


def test_set_inputs_mm_type(tiny_runner):
    """A per-task ``mm_type`` other than the loaded one raises, as in the
    JAX runner; the loaded one passes."""
    r = tiny_runner
    with pytest.raises(ValueError, match="load"):
        r.set_inputs({"mm_type": "W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu"})
    r.set_inputs({"mm_type": r.mm_type, "seed": 42})
    assert r.config["seed"] == 42 and "mm_type" not in r.config


def _wav(path, seconds, sr=16000):
    import wave

    t = np.arange(int(seconds * sr)) / sr
    s = (np.sin(2 * np.pi * 220 * t) * 18000).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(s.tobytes())
    return str(path)


# the tiny Wan stack: dim 256 (the small T5's width), 2 heads of 128, 1 block; 5 frames of 32 x 32
TINY_WAN = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=1, text_dim=256, text_len=16, freq_dim=256,
                target_video_length=5, target_height=32, target_width=32, infer_steps=2, sample_shift=5,
                self_attn_1_type="flash_attn3", cross_attn_1_type="flash_attn3", enable_cfg=False)
SERVE_TWICE = {
    "wan2.1": dict(TINY_WAN, enable_cfg=True, negative_prompt="blurry"),
    # run 1's latents (2, 4, 9) bucket to (4, 8, 16) and crop back; run 2's (4, 8, 8) bucket to themselves
    "wan2.1_distill": dict(TINY_WAN, shape_bucketing=True, denoising_step_list=[1000, 500], target_width=72),
    "wan2.1_causvid": dict(TINY_WAN, num_frames=2, num_frame_per_block=1, num_blocks=2, num_fragments=2,
                           denoising_step_list=[999, 500]),
    "wan2.1_skyreels_v2_df": dict(TINY_WAN, enable_cfg=True, ar_step=0, addnoise_condition=0, base_num_frames=5,
                                  overlap_history=0),
    # a 0.82 s wav at 16 fps: 13 frames, 2 segments of 9 overlapping by 5, the second conditioned on the first
    "wan2.1_audio": dict(TINY_WAN, target_video_length=9, video_duration=1),
    "hunyuan": dict(target_video_length=5, target_height=32, target_width=32, infer_steps=2, text_len=16,
                    attention_type="flash_attn3"),
    "cogvideox": dict(target_video_length=5, target_height=32, target_width=32, infer_steps=2),
}


# the per-run state of the caching loop and of the host-RAM offload tier, on the Wan runners
SERVE_TWICE_MODES = {
    "wan2.1-Tea": ("wan2.1", dict(TINY_WAN, infer_steps=4, feature_caching="Tea", teacache_thresh=1.5,
                                  coefficients=[[1.0, 0.0], [1.0, 0.0]])),
    "wan2.1_distill-cpu_offload": ("wan2.1_distill", dict(TINY_WAN, denoising_step_list=[1000, 500],
                                                          cpu_offload=True)),
}
CASES = {**{k: (k, v) for k, v in SERVE_TWICE.items()}, **SERVE_TWICE_MODES}


@pytest.mark.parametrize("case", list(CASES))
def test_runner_serves_twice_as_once(case, tmp_path):
    """Run 1 (seed 1, one prompt), then run 2 (seed 2, another prompt) on
    the same runner, through ``set_inputs`` as the service feeds them: run 2
    equals a fresh runner's run 2 bit for bit (its audio track too)."""
    from lightx2v_tpu_torch import infer
    from lightx2v_tpu_torch.utils.config import set_config

    model_cls, extra = CASES[case]
    cfg = dict(extra, model_cls=model_cls, synthetic_weights=True, device="cpu")
    if model_cls == "wan2.1_audio":
        cfg["audio_path"] = _wav(tmp_path / "a.wav", 0.82)
    run1 = {"prompt": "a red panda", "seed": 1}
    run2 = {"prompt": "a lighthouse in a storm", "seed": 2}
    if case == "wan2.1_distill":
        run2.update(target_video_length=13, target_height=64, target_width=64)
    served = infer.init_runner(set_config(dict(cfg, **run1)))
    served.run_pipeline(save_video=False)
    served.set_inputs(dict(run2))
    got = served.run_pipeline(save_video=False)
    fresh = infer.init_runner(set_config(dict(cfg, **run2)))
    want = fresh.run_pipeline(save_video=False)
    np.testing.assert_array_equal(got, want)
    assert {k for k in served.timings if k.startswith(("dit_s", "decode_s"))} == \
        {k for k in fresh.timings if k.startswith(("dit_s", "decode_s"))}
    if model_cls == "wan2.1_audio":
        assert got.shape[0] == 13 and len(served.timings["step_s"]) == 4  # 2 segments of 2 steps
        np.testing.assert_array_equal(served.audio_track[0], fresh.audio_track[0])
    if case == "wan2.1_distill":
        assert got.shape == (13, 64, 64, 3) and "crop_output" not in served.config
    if case.endswith("Tea"):  # the cache skipped a step of each run
        assert not all(served.timings["calc_steps"]) and served.timings["calc_steps"] == fresh.timings["calc_steps"]
    if case.endswith("offload"):
        assert len(served.timings["offload"]) == 2 and served.timings["offload"] == fresh.timings["offload"]


def _boxes(raw, lo, hi):
    out = []
    while lo < hi:
        size, cc = struct.unpack(">I4s", raw[lo:lo + 8])
        out.append((cc, lo, size))
        lo += size
    return out


def test_mjpeg_writer_decodes_within_jpeg_error(tmp_path):
    """``write_mjpeg_mp4`` (the writer the card machine runs, forced here by
    calling it directly): ftyp, mdat, moov; one ``mp4v`` track whose stsz
    and stco locate each sample; every sample a JPEG that PIL decodes to the
    input within JPEG's error, mean abs <= 3 of 255."""
    from PIL import Image

    from lightx2v_tpu_torch.utils.media import to_uint8_frames, write_mjpeg_mp4

    rng = np.random.default_rng(0)
    t, h, w = 6, 48, 80
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    base = np.stack([np.sin(3 * xx + k) * np.cos(2 * yy) for k in range(3)], -1)
    video = np.stack([np.roll(base, i, axis=1) for i in range(t)]) * 0.8 + rng.normal(0, 0.01, (t, h, w, 3))
    video = video.astype(np.float32)
    path = write_mjpeg_mp4(video, str(tmp_path / "v.mp4"), fps=16)
    raw = Path(path).read_bytes()
    top = _boxes(raw, 0, len(raw))
    assert [c for c, _, _ in top] == [b"ftyp", b"mdat", b"moov"] and sum(s for _, _, s in top) == len(raw)
    moov = raw[top[2][1]:]
    assert moov.count(b"trak") == 1 and b"mp4v" in moov and b"sowt" not in moov
    stsz = moov.index(b"stsz")
    n = struct.unpack(">I", moov[stsz + 12:stsz + 16])[0]
    sizes = struct.unpack(f">{n}I", moov[stsz + 16:stsz + 16 + 4 * n])
    off = struct.unpack(">I", moov[moov.index(b"stco") + 12:moov.index(b"stco") + 16])[0]
    assert n == t and off == top[1][1] + 8 and sum(sizes) == top[1][2] - 8
    want = to_uint8_frames(video).astype(np.float64)
    for i, size in enumerate(sizes):
        img = np.asarray(Image.open(io.BytesIO(raw[off:off + size])).convert("RGB"), np.float64)
        assert img.shape == (h, w, 3)
        assert np.abs(img - want[i]).mean() <= 3.0
        off += size


def test_cache_video_writes_mjpeg_without_imageio_or_cv2(monkeypatch, tmp_path):
    import builtins

    from lightx2v_tpu_torch.utils import media

    real_import = builtins.__import__

    def no_writers(name, *a, **kw):
        if name in ("imageio", "cv2"):
            raise ImportError(name)
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_writers)
    out = media.cache_video(np.zeros((2, 8, 8, 3), np.float32), str(tmp_path / "x.mp4"))
    assert out == str(tmp_path / "x.mp4") and Path(out).read_bytes()[4:8] == b"ftyp"


def test_async_save(tmp_path, monkeypatch):
    from lightx2v_tpu_torch.utils import async_io, media

    monkeypatch.setattr(media, "video_writer", lambda: None)
    frames = np.zeros((2, 8, 8, 3), np.float32)
    fut = async_io.save_video_async(frames, str(tmp_path / "a.mp4"))
    frames += 1.0  # the saved frames are a snapshot
    assert fut.result(timeout=WAIT) == str(tmp_path / "a.mp4")


def test_launcher_pins_one_gpu_a_server():
    from lightx2v_tpu_torch.api_multi_servers import find_free_ports, server_env

    assert [server_env(i, 4)["CUDA_VISIBLE_DEVICES"] for i in range(6)] == ["0", "1", "2", "3", "0", "1"]
    assert "CUDA_VISIBLE_DEVICES" not in server_env(0, 0) or os.environ.get("CUDA_VISIBLE_DEVICES")
    ports = find_free_ports(20000, 3)
    assert len(set(ports)) == 3


def test_api_server_flags():
    from lightx2v_tpu_torch import api_server

    seen = {}

    class FakeServer:
        def __init__(self, service, host, port, output_root):
            seen.update(service=service, host=host, port=port, root=output_root)
            self.port = port

        def serve_forever(self):
            seen["service"].shutdown()

    argv = ["api_server", "--model_cls", "wan2.1", "--config_json", SMOKE, "--synthetic_weights", "--device",
            "cpu", "--host", "127.0.0.1", "--port", "0", "--compile_cache_dir", "/nonexistent"]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr("sys.argv", argv)
        mp.setattr(api_server, "ApiServer", FakeServer)
        api_server.main()
    finally:
        mp.undo()
    assert seen["host"] == "127.0.0.1" and seen["root"] == "./outputs"
    assert seen["service"].server_config["device"] == "cpu" and seen["service"].num_replicas == 1


def test_metadata_lists_the_ports_capabilities():
    from lightx2v_tpu_torch.server.autoconfig import auto_configure, service_metadata
    from lightx2v_tpu_torch.utils.registry import ATTN_REGISTER

    meta = service_metadata({"model_cls": "wan2.1_distill", "dim": 5120,
                             "mm_config": {"mm_type": "W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu"}})
    assert [n for n, _ in meta["attention_ops"]] == list(ATTN_REGISTER.keys())
    assert meta["device"]["backend"] == "cpu" and meta["device"]["hbm_gb"] is None
    assert dict(meta["quant_schemes"])["fp8_block128"] is False
    assert meta["active_quant_scheme"] == "int8"
    assert len(meta["model_matrix"]) == 7
    assert auto_configure("832x480", "14b", hbm_gb=8, host_ram_gb=12)["lazy_load"]


def test_unknown_error_body_is_json(tmp_path):
    """A task whose runner raises ends ``failed`` with the error in its
    status body."""
    from lightx2v_tpu_torch.server.api import ApiServer
    from lightx2v_tpu_torch.server.service import VideoGenerationService

    class Broken:
        config = {"device": "cpu"}

        def set_inputs(self, inputs):
            pass

        def run_pipeline(self):
            raise RuntimeError("out of memory")

    service = VideoGenerationService(Broken, output_root=str(tmp_path))
    srv = ApiServer(service, host="127.0.0.1", port=0, output_root=str(tmp_path))
    srv.serve_background()
    try:
        code, body = _req(srv.port, "POST", "/v1/tasks", {"prompt": "x"})
        _until(lambda: service.get(body["task_id"]).status == "failed", "the failure")
        code, st = _req(srv.port, "GET", f"/v1/tasks/{body['task_id']}/status")
        assert code == 200 and st["error"] == "out of memory"
        assert service.metrics()["tasks_failed"] == 1 and service.metrics()["last_stage_seconds"] == {}
    finally:
        srv.shutdown()
