"""The port's stdlib HTTP server (serving/http_server.py), its page, client
and load generator (tools/bench_client.py) on the CPU: over the JAX tests'
FakeModel double every endpoint, 400 on a bad body or endpoint, 404,
/metrics and /metrics/reset, the `stream` flag's string coercion and the
index page, each response byte for byte the JAX package's
`make_stdlib_server` over the same double; and over a tiny port API
(`CosyVoice2(device="cpu")`, greedy) with continuous batching: a request's
PCM is `_pcm` of the API's own output, offline and streamed, and
`bench_client.sweep` serves every request at concurrency 1 and 2; with
no batching, overlapping requests are each served whole, one at a time."""

import base64
import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from cosyvoice_tpu_torch.serving import http_server
from cosyvoice_tpu_torch.serving.http_client import request
from cosyvoice_tpu_torch.tools import bench_client
from tests.test_serving import FakeModel

torch.set_num_threads(1)

PROMPT_B64 = base64.b64encode(np.zeros(1600, np.int16).tobytes()).decode()
BODIES = {
    "inference_zero_shot": {"tts_text": "hi", "prompt_text": "p", "prompt_audio_b64": PROMPT_B64},
    "inference_cross_lingual": {"tts_text": "hi", "prompt_audio_b64": PROMPT_B64, "stream": "false"},
    "inference_sft": {"tts_text": "hi", "spk_id": "a", "stream": "1"},
    "inference_instruct": {"tts_text": "hi", "spk_id": "a", "instruct_text": "slowly"},
    "inference_instruct2": {"tts_text": "hi", "instruct_text": "slowly", "prompt_audio_b64": PROMPT_B64},
}


def _serve(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server.server_address[1]


@pytest.fixture(scope="module")
def servers():
    """The port's and the JAX package's stdlib servers over FakeModel, on free ports."""
    from cosyvoice_tpu.serving.http_server import make_stdlib_server as jax_server

    port_srv = http_server.make_stdlib_server(FakeModel(), host="127.0.0.1", port=0)
    jax_srv = jax_server(FakeModel(), host="127.0.0.1", port=0)
    yield _serve(port_srv), _serve(jax_srv)
    for srv in (port_srv, jax_srv):
        srv.shutdown()
        srv.server_close()


def _call(port, method, path, body=None):
    """(status, body bytes) of one request on a connection of its own."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("endpoint", list(BODIES))
def test_endpoint_pcm_equals_jax_server(servers, endpoint):
    """Every endpoint streams FakeModel's two chunks as int16 PCM (1500
    samples), the JAX server's bytes."""
    ours, theirs = (_call(p, "POST", f"/{endpoint}", json.dumps(BODIES[endpoint])) for p in servers)
    assert ours[0] == theirs[0] == 200
    assert ours[1] == theirs[1]
    pcm = np.frombuffer(ours[1], np.int16)
    assert len(pcm) == 1500 and pcm[0] == int(0.1 * 32767) and pcm[-1] == int(-0.1 * 32767)


@pytest.mark.parametrize("path,body", [("/nope", "{}"), ("/inference_zero_shot", "{not json"),
                                       ("/inference_zero_shot", json.dumps({"tts_text": "hi"})),
                                       ("/inference_sft", json.dumps({"spk_id": "a"}))])
def test_bad_request_is_400_as_jax(servers, path, body):
    ours, theirs = (_call(p, "POST", path, body) for p in servers)
    assert ours[0] == theirs[0] == 400
    assert ours[1] == theirs[1] and ours[1]


@pytest.mark.parametrize("path", ["/nope", "/metrics/x"])
def test_unknown_get_is_404(servers, path):
    ours, theirs = (_call(p, "GET", path) for p in servers)
    assert ours[0] == theirs[0] == 404


def test_metrics_and_reset_as_jax(servers):
    """After /metrics/reset, two requests: both servers count them and the
    audio seconds alike; a reset clears them."""
    for port in servers:
        assert _call(port, "POST", "/metrics/reset", "") == (200, b'{"ok": true}')
        for endpoint in ("inference_zero_shot", "inference_sft"):
            assert _call(port, "POST", f"/{endpoint}", json.dumps(BODIES[endpoint]))[0] == 200
    ours, theirs = (json.loads(_call(p, "GET", "/metrics")[1]) for p in servers)
    assert ours == theirs
    assert ours["requests"] == {"inference_zero_shot": 1, "inference_sft": 1}
    assert ours["audio_seconds"] == pytest.approx(2 * 1500 / 24000)
    _call(servers[0], "POST", "/metrics/reset")
    assert json.loads(_call(servers[0], "GET", "/metrics")[1]) == {"requests": {}, "audio_seconds": 0.0}


def test_stream_flag_string_coercion():
    from cosyvoice_tpu.serving.http_server import _truthy as jax_truthy

    values = [True, False, "true", "1", "Yes", " on ", "false", "0", "", "no", 0, 1, None]
    assert [http_server._truthy(v) for v in values] == [jax_truthy(v) for v in values]
    assert http_server._truthy("true") and not http_server._truthy("false")


def test_index_page(servers):
    status, page = _call(servers[0], "GET", "/")
    assert status == 200
    page = page.decode()
    assert page.startswith("<!doctype html>") and "const SR = 24000" in page
    for endpoint in BODIES:
        assert endpoint in page
    assert _call(servers[1], "GET", "/")[1].count(b"inference_") == page.count("inference_")


def test_bench_client_sweep_over_fake_model(servers):
    lines = bench_client.sweep("127.0.0.1", servers[0], "inference_zero_shot", BODIES["inference_zero_shot"],
                               [1, 2], 3, quiet=True)
    assert [(ln["concurrency"], ln["n_requests"], ln["errors"]) for ln in lines] == [(1, 3, 0), (2, 3, 0)]
    for ln in lines:
        assert ln["audio_s_total"] == pytest.approx(3 * 1500 / 24000)
        assert 0 < ln["first_chunk_s"]["p50"] <= ln["latency_s"]["p50"] and ln["request_rtf"]["p90"] > 0


# ---------------------------------------------------------------- a tiny port API behind the server


def _tiny_api(tmp_path_factory):
    from tests.test_torch_api import CAM, EOS_BIAS, _write_dir

    from cosyvoice_tpu_torch.models.campplus import CamPPConfig, CamPPEmbedding
    from cosyvoice_tpu_torch.runtime.api import CosyVoice2

    api = CosyVoice2(_write_dir(tmp_path_factory.mktemp("m")), device="cpu", seed=0)
    api.frontend.campplus = CamPPEmbedding(CamPPConfig(**CAM))
    with torch.no_grad():
        api.lm.module.llm_decoder.bias[api.lm.cfg.eos_token] += EOS_BIAS
    return api


@pytest.fixture(scope="module")
def api_server(tmp_path_factory):
    api = _tiny_api(tmp_path_factory)
    sched = api.enable_continuous_batching(max_batch=2)
    srv = http_server.make_stdlib_server(api, host="127.0.0.1", port=0)
    port = _serve(srv)
    yield api, port
    srv.shutdown()
    srv.server_close()
    sched.stop()


def _voice_b64(seconds=1.0):
    wav = np.random.default_rng(0).standard_normal(int(16000 * seconds)) * 0.1
    return base64.b64encode((np.clip(wav, -1, 1) * 32767).astype(np.int16).tobytes()).decode()


@pytest.mark.parametrize("stream", [False, True], ids=["offline", "stream"])
def test_api_request_pcm_equals_the_api_output(api_server, stream):
    """A zero-shot request through the server: the PCM of the API's own
    call on the same text and the prompt as the server decodes it; as many
    samples as its tokens give."""
    api, port = api_server
    body = {"tts_text": "Hello there.", "prompt_text": "A cue.", "prompt_audio_b64": _voice_b64(), "stream": stream}
    pcm = request("127.0.0.1", port, "inference_zero_shot", body)
    outs = list(api.inference_zero_shot(body["tts_text"], body["prompt_text"],
                                        http_server._wav_from_b64(body["prompt_audio_b64"]), stream=stream))
    want = b"".join(http_server._pcm(o["tts_speech"]) for o in outs)
    n_tok = sum(len(o["speech_tokens"]) for o in outs)
    assert n_tok > 0 and len(pcm) == n_tok * 2 * 480
    assert pcm.tobytes() == want
    assert len(outs) > 1 if stream else len(outs) == 1


def test_bench_client_sweep_over_the_api(api_server):
    """Concurrency 1 and 2, two requests each, offline and streamed: every
    request served, its audio the random LM's tokens' length."""
    api, port = api_server
    body = {"tts_text": "Hi.", "prompt_text": "A cue.", "prompt_audio_b64": _voice_b64()}
    for stream in (False, True):
        lines = bench_client.sweep("127.0.0.1", port, "inference_zero_shot", {**body, "stream": stream}, [1, 2], 2,
                                   quiet=True)
        assert [(ln["n_requests"], ln["errors"]) for ln in lines] == [(2, 0), (2, 0)]
        assert all(ln["audio_s_total"] > 0 and ln["server_stages"] for ln in lines)
    m = json.loads(_call(port, "GET", "/metrics")[1])
    assert m["requests"]["inference_zero_shot"] >= 8


# ---------------------------------------------------------------- the same API with no batching


@pytest.fixture(scope="module")
def serial_server(tmp_path_factory):
    api = _tiny_api(tmp_path_factory)
    srv = http_server.make_stdlib_server(api, host="127.0.0.1", port=0)
    port = _serve(srv)
    yield api, port
    srv.shutdown()
    srv.server_close()


def test_overlapping_requests_without_batching_are_whole(serial_server):
    """No scheduler: three requests sent at once (offline, streamed, and
    offline on another text) each get the whole PCM of the API's own output
    for its body, as alone: the API runs them one at a time (the LM decodes
    one request at a time)."""
    api, port = serial_server
    voice = _voice_b64()
    bodies = [{"tts_text": text, "prompt_text": "A cue.", "prompt_audio_b64": voice, "stream": stream}
              for text, stream in (("Hello there.", False), ("Hello there.", True), ("Good day.", False))]
    want = [b"".join(http_server._pcm(o["tts_speech"]) for o in api.inference_zero_shot(
        b["tts_text"], b["prompt_text"], http_server._wav_from_b64(voice), stream=b["stream"])) for b in bodies]
    barrier = threading.Barrier(len(bodies))
    got = [None] * len(bodies)

    def send(i):
        barrier.wait()
        try:
            got[i] = request("127.0.0.1", port, "inference_zero_shot", bodies[i]).tobytes()
        except Exception as e:  # noqa: BLE001 — compared below
            got[i] = e

    threads = [threading.Thread(target=send, args=(i,), daemon=True) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert all(len(w) for w in want)
    for g, w in zip(got, want):
        assert g == w


def test_a_request_waits_for_the_running_one(serial_server):
    """No scheduler: a request made while a streamed one is between chunks
    waits (it neither raises nor runs beside it) and ends once that one
    has; both give what they give alone."""
    api, _ = serial_server
    args = ("Hello there.", "A cue.", http_server._wav_from_b64(_voice_b64()))
    alone_stream = list(api.inference_zero_shot(*args, stream=True))
    alone = list(api.inference_zero_shot(*args))
    first = api.inference_zero_shot(*args, stream=True)
    chunks = [next(first)]
    out = {}

    def second():
        try:
            out["chunks"] = list(api.inference_zero_shot(*args))
        finally:
            out["end"] = time.perf_counter()

    t = threading.Thread(target=second, daemon=True)
    t.start()
    t.join(2.0)
    assert t.is_alive() and not out
    chunks += list(first)
    first_end = time.perf_counter()
    t.join(120)
    assert out["end"] > first_end
    for got, want in ((chunks, alone_stream), (out["chunks"], alone)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["speech_tokens"], w["speech_tokens"])
            np.testing.assert_array_equal(g["tts_speech"], w["tts_speech"])
